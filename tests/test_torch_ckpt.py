"""The port's checkpoints (``repro_torch/ckpt``) against the reference's
(``repro/ckpt/checkpoint.py``): the reference's five tests mirrored, and
each side reading what the other wrote.

Both write the same format, so the same tree saved by each gives equal
manifests (paths, files, shapes, dtypes, sha256) and equal leaf bytes:
f32, bf16 and int32 leaves, compared exactly. A train state's layout-free
view (``train.step.state_view``) is the reference's ``TrainState`` tree,
so the reference restores a port train-state checkpoint onto its own
state template.
"""
import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as jck
from repro_torch.ckpt import checkpoint as ck


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(seed=0):
    """The reference test's tree as numpy (bf16 as its int16 bits)."""
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(4, 8)).astype(np.float32),
            "b": {"c": r.normal(size=(3,)).astype(np.float32),
                  "d": r.integers(0, 5, (2, 2)).astype(np.int32)},
            "bf": np.asarray(jnp.asarray(r.normal(size=(5,)), jnp.bfloat16))}


def _tree(seed=0):
    """The same tree as torch tensors."""
    t = _np_tree(seed)
    return {"a": torch.from_numpy(t["a"]),
            "b": {"c": torch.from_numpy(t["b"]["c"]),
                  "d": torch.from_numpy(t["b"]["d"])},
            "bf": torch.from_numpy(np.array(t["bf"]).view(np.int16)).view(
                torch.bfloat16)}


def _zeros_like(tree):
    return jax.tree.map(torch.zeros_like, tree)


def _leaves(tree):
    return [v for _, v in ck.flatten(tree)]


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 7, t, metadata={"note": "x"})
    assert ck.latest_step(str(tmp_path)) == 7
    back = ck.restore(str(tmp_path), template=_zeros_like(t))
    for a, b in zip(_leaves(t), _leaves(back)):
        assert torch.equal(a, b)
        assert a.dtype == b.dtype
    assert _manifest(tmp_path / "step_00000007")["metadata"] == {"note": "x"}


def test_corruption_detected(tmp_path):
    """A flipped byte raises ``IOError`` with the reference's text."""
    t = _tree()
    path = ck.save(str(tmp_path), 1, t)
    victim = os.path.join(path, "leaf_00000.bin")
    raw = bytearray(open(victim, "rb").read())
    raw[0] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum") as got:
        ck.restore(str(tmp_path), template=_zeros_like(t))
    with pytest.raises(IOError) as want:
        jck.restore(str(tmp_path))
    assert str(got.value) == str(want.value)


def test_gc_keeps_last(tmp_path):
    t = _tree()
    for s in range(6):
        ck.save(str(tmp_path), s, t, keep_last=3)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [3, 4, 5]


def test_async_checkpointer(tmp_path):
    """The host copy is taken before ``save`` returns: an in-place update
    right after it does not reach the checkpoint."""
    t = _tree()
    want = [x.clone() for x in _leaves(t)]
    saver = ck.AsyncCheckpointer()
    saver.save(str(tmp_path), 11, t)
    t["a"].add_(1.0)
    saver.wait()
    assert ck.latest_step(str(tmp_path)) == 11
    _, back = ck.restore(str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(want, back))
    rec = saver.records[0]
    assert rec["step"] == 11 and rec["bytes"] == sum(
        x.numel() * x.element_size() for x in want)
    assert rec["copy_ms"] >= 0 and rec["write_ms"] >= 0
    saver.close()


def test_restore_in_place(tmp_path):
    """The bytes on disk are layout-free: restore writes them into the
    template's own tensors, which keep their identity."""
    t = _tree()
    ck.save(str(tmp_path), 2, t)
    dst = _zeros_like(t)
    ptrs = [x.data_ptr() for x in _leaves(dst)]
    back = ck.restore(str(tmp_path), template=dst)
    assert back is dst
    assert [x.data_ptr() for x in _leaves(dst)] == ptrs
    assert torch.equal(dst["a"], t["a"])
    bad = _zeros_like(t)
    bad["a"] = torch.zeros(4, 9)
    with pytest.raises(ValueError, match="template does not match"):
        ck.restore(str(tmp_path), template=bad)


def _check_same_checkpoint(port_path, ref_path):
    """Equal manifests (bar metadata) and equal leaf files."""
    a, b = _manifest(port_path), _manifest(ref_path)
    assert a["leaves"] == b["leaves"]
    assert a["step"] == b["step"]
    assert {e["dtype"] for e in a["leaves"]} == {"float32", "int32", "bfloat16"}
    for e in a["leaves"]:
        assert open(os.path.join(port_path, e["file"]), "rb").read() == \
            open(os.path.join(ref_path, e["file"]), "rb").read()


def test_reference_checkpoint_reads_in_port(tmp_path):
    """The reference's ``save`` read by the port's ``restore``: bytes,
    shapes, dtypes and sha256 equal."""
    jt = jax.tree.map(jnp.asarray, _np_tree())
    ref = jck.save(str(tmp_path / "ref"), 5, jt, metadata={"loss": 1.5})
    manifest, leaves = ck.restore(str(tmp_path / "ref"))
    assert manifest["metadata"] == {"loss": 1.5}
    for e, got, want in zip(manifest["leaves"], leaves, jax.tree.leaves(jt)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert ck.DTYPES[str(want.dtype)] == got.dtype
        assert _bytes(got) == _bytes(want)
        assert hashlib.sha256(_bytes(got)).hexdigest() == e["sha256"]
    back = ck.restore(str(tmp_path / "ref"), template=_zeros_like(_tree()))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back),
                                                 _leaves(_tree())))
    port = ck.save(str(tmp_path / "port"), 5, _tree())
    _check_same_checkpoint(port, ref)


def test_port_checkpoint_reads_in_reference(tmp_path):
    """The port's ``save`` read by the reference's ``restore(dir)``."""
    t = _tree()
    ck.save(str(tmp_path), 3, t, metadata={"loss": 2.0})
    manifest, leaves = jck.restore(str(tmp_path))
    assert manifest["metadata"] == {"loss": 2.0}
    for e, got, want in zip(manifest["leaves"], leaves, _leaves(t)):
        assert got.shape == tuple(want.shape)
        assert ck.DTYPES[str(got.dtype)] == want.dtype
        assert _bytes(got) == _bytes(want)
        assert hashlib.sha256(_bytes(got)).hexdigest() == e["sha256"]
    back = jck.restore(str(tmp_path), template=jax.tree.map(jnp.asarray,
                                                           _np_tree()))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np_tree())):
        assert _bytes(a) == _bytes(b)


def test_train_state_checkpoint_restores_in_reference(tmp_path):
    """A port train state's checkpoint (W=1, ZeRO-1 off, compressed with
    error feedback) has the paths, shapes and dtypes of the reference's
    ``TrainState`` and restores onto the reference's state template."""
    from repro.compat import make_mesh
    from repro.configs.granite_3_2b import ARCH as JARCH
    from repro.models import model_api as j_model_api
    from repro.parallel.sharding import ShardingProfile
    from repro.train import TrainConfig as JTrain
    from repro.train.step import init_train_state as j_init_train_state
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    from repro_torch.train.config import TrainConfig
    from repro_torch.train.step import init_train_state, state_view

    tc = TrainConfig(workers=1, zero1=False)
    state = init_train_state(model_api(get_arch("granite-3-2b").smoke), tc,
                             "cpu")
    with torch.no_grad():
        for i, p in enumerate(state.params.leaves()):
            state.opt["m"][i].fill_(0.5 + i)
            state.residual[i].fill_(-1.0 - i)
    state.step = 9
    ck.save(str(tmp_path), 9, state_view(state, tc))
    jstate = j_init_train_state(
        j_model_api(JARCH.smoke), JTrain(sharding=ShardingProfile(zero1=False)),
        make_mesh((1, 1), ("data", "model")), jax.random.PRNGKey(0))
    want = [(p, list(np.shape(a)), str(np.asarray(a).dtype))
            for p, a in zip(jck._leaf_paths(jstate), jax.tree.leaves(jstate))]
    got = [(e["path"], e["shape"], e["dtype"])
           for e in _manifest(tmp_path / "step_00000009")["leaves"]]
    assert got == want
    back = jck.restore(str(tmp_path), template=jstate)
    assert int(back.step) == 9
    for a, b in zip(jax.tree.leaves(back.params), state.params.leaves()):
        assert _bytes(a) == _bytes(b.detach())
    for a, b in zip(jax.tree.leaves(back.opt["m"]), state.opt["m"]):
        assert _bytes(a) == _bytes(b)
    for a, b in zip(jax.tree.leaves(back.residual), state.residual):
        assert _bytes(a) == _bytes(b)


def test_launcher_defaults_match_reference():
    """``--steps`` defaults to 100 and ``--ckpt-every`` to 50, as the
    reference launcher's; ``--compression-ratio`` and ``--ckpt-dir``
    default to off."""
    from repro_torch.launch.train import build_parser
    args = build_parser().parse_args(["--arch", "granite-3-2b"])
    assert (args.steps, args.ckpt_every, args.ckpt_dir,
            args.compression_ratio) == (100, 50, None, None)


def test_launcher_checkpoints_and_resumes_on_ranks(tmp_path):
    """``--ckpt-dir`` / ``--ckpt-every`` / ``--compression-ratio`` on the
    emulated workers, then the same directory resumed by ``--procs 2``:
    the ranks start from the emulation's latest checkpoint."""
    from repro_torch.launch.train import main
    common = ["--arch", "granite-3-2b", "--smoke", "--global-batch", "4",
              "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
              str(tmp_path), "--ckpt-every", "2", "--compression-ratio", "0.2"]
    out = main(common + ["--steps", "4"])
    assert (out["restarts"], out["final_step"], out["ratio"], out["remat"]) \
        == (0, 4, 0.2, "none")
    assert len(out["losses"]) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]
    out = main(common + ["--steps", "6", "--procs", "2"])
    assert (out["procs"], out["restarts"], out["final_step"]) == (2, 0, 6)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert ck.latest_step(str(tmp_path)) == 6
