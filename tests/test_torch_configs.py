"""The port's architecture and shape registries against the reference's:
every arch of ``repro.configs.ARCHS`` with equal ``model``, ``smoke``
and ``train`` fields, the same analytic parameter counts, shape cells,
shape rule and batch shapes and dtypes; and smoke-size training of the
two settings no other file runs:

- qwen2-7b, dense with ``qkv_bias`` (``layers.py:_project_qkv``'s bias
  path), with the config's AdamW;
- kimi-k2-1t-a32b, MoE with a shared expert, the ``dense`` aggregator,
  momentum with a bfloat16 state and no error feedback, the config's
  train settings.

Both at W=2 against the reference's composed W=2 step
(``test_torch_family_train.jax_w2_losses``: the f32 mean of the two
workers' gradients, the replicated update), 3 steps, losses to
rtol=1e-5, from the port's draws from seed 0 given to both sides. The
optimizers keep their kind and state dtype; the learning rate is 1e-2
with no warmup or clipping, so that the parameters move in 3 steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import make_batch_struct as j_make_batch_struct
from repro_torch.configs import SHAPES, get_arch, list_archs, make_batch_struct
from repro_torch.convert import params_to_numpy
from repro_torch.data.pipeline import batch_fn
from repro_torch.models.registry import model_api
from repro_torch.models.transformer import PORTED_FAMILIES
from test_torch_family_train import B, S, jax_w2_losses, port_w2

TRAIN_FIELDS = ("aggregator", "compression", "optimizer", "remat",
                "accum_steps", "ep_exchange", "rs_gather_skip", "seed")


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_the_reference_s_but_encdec():
    """The registry is the reference's whole, encdec (whisper-tiny)
    included, over the six families; an unknown name raises KeyError."""
    assert list_archs() == sorted(J_ARCHS)
    assert "whisper-tiny" in list_archs()
    assert {a.model.family for a in J_ARCHS.values()} == set(PORTED_FAMILIES)
    assert get_arch("whisper-tiny").model.family == "encdec"
    with pytest.raises(KeyError, match="bogus"):
        get_arch("bogus")


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_arch_fields_equal_reference(name):
    got, want = get_arch(name), J_ARCHS[name]
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert dataclasses.asdict(got.smoke) == dataclasses.asdict(want.smoke)
    for f in TRAIN_FIELDS:
        a, b = getattr(got.train, f), getattr(want.train, f)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f
    assert got.source == want.source


def test_encdec_raises_not_implemented():
    """The analytic counts and the shape registry of every arch, model and
    smoke, equal the reference's: ``param_count`` and
    ``active_param_count`` (for whisper-tiny the reference's formula,
    41,159,040, where its tree has 36,487,680), ``SHAPES``,
    ``shape_supported`` on each cell, and ``make_batch_struct``'s keys,
    shapes and dtypes (``meta`` tensors against ``ShapeDtypeStruct``s);
    and the encdec family builds and draws batches (``model_api``,
    ``batch_fn``) where it once raised ``NotImplementedError``."""
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for name, jarch in J_ARCHS.items():
        arch = get_arch(name)
        for got, want in ((arch.model, jarch.model), (arch.smoke, jarch.smoke)):
            assert got.param_count() == want.param_count(), name
            assert got.active_param_count() == want.active_param_count(), name
            for sb in (4, 2), (3, 16):
                ours = make_batch_struct(got, *sb)
                theirs = j_make_batch_struct(want, *sb)
                assert sorted(ours) == sorted(theirs), name
                for k, t in ours.items():
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == theirs[k].shape, (name, k)
                    assert str(t.dtype) == f"torch.{theirs[k].dtype}", (name, k)
        for shape in J_SHAPES.values():
            assert arch.shape_supported(SHAPES[shape.name]) == \
                jarch.shape_supported(shape), (name, shape.name)
    assert get_arch("whisper-tiny").model.param_count() == 41_159_040
    smoke = get_arch("whisper-tiny").smoke
    assert model_api(smoke).cfg.family == "encdec"
    assert batch_fn(smoke, B, S)(0)["frames"].shape == \
        (B, smoke.enc_seq, smoke.d_model)


@pytest.mark.parametrize("name", ["qwen2-7b", "kimi-k2-1t-a32b"])
def test_smoke_training_matches_reference(name):
    arch = get_arch(name)
    cfg = arch.smoke
    tc = arch.train
    ocfg = {**dataclasses.asdict(tc.optimizer), "lr": 1e-2, "warmup_steps": 0,
            "grad_clip": 0.0}
    np_params = params_to_numpy(model_api(cfg).init(0, "cpu"))
    got = port_w2(cfg, np_params, "dense", 3, ocfg,
                  dataclasses.asdict(tc.compression))
    want = jax_w2_losses(J_ARCHS[name].smoke, np_params, 3, ocfg)
    np.testing.assert_allclose(got.losses, want, rtol=1e-5)
    if name == "kimi-k2-1t-a32b":
        assert tc.aggregator == "dense" and not tc.compression.error_feedback
        assert got.state.opt["m"][0].dtype == torch.bfloat16
        assert "v" not in got.state.opt
        assert all(r.numel() == 0 for r in got.state.residual)
        assert "shared" in got.state.params.tree()["layers"]["moe"]
    else:
        assert "bq" in got.state.params.tree()["layers"]["attn"]


NEW_ARCHS = ("qwen2-7b", "qwen2.5-3b", "qwen1.5-32b", "mamba2-1.3b",
             "internvl2-2b", "jamba-v0.1-52b", "kimi-k2-1t-a32b",
             "whisper-tiny")


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_launchers_take_the_arch(capsys, name):
    """``launch.train`` and ``launch.serve`` on the CPU at the smoke
    size: a finite loss from one step of the arch's train settings, and greedy tokens
    of the batch's shape (the serve launcher passes no ``vis_embed``, and
    ``frames`` for encdec, as the reference's)."""
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train
    out = train(["--arch", name, "--smoke", "--steps", "1", "--global-batch",
                 "2", "--seq-len", "16", "--device", "cpu"])
    assert out["arch"] == name and len(out["losses"]) == 1
    assert out["aggregator"] == get_arch(name).train.aggregator
    assert all(np.isfinite(out["losses"]))
    toks = serve(["--arch", name, "--smoke", "--batch", "2", "--prompt-len",
                  "8", "--max-new", "4", "--device", "cpu"])
    assert toks.shape == (2, 4)
    assert ((toks >= 0) & (toks < get_arch(name).smoke.vocab)).all()
    capsys.readouterr()
