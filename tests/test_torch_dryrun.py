"""The dry run (``repro_torch.launch.dryrun``) against the reference's
compiled cells and against a real grid.

- ``argument_bytes``: the meta trace of the prefill and decode cells of
  granite-3-2b (B 4 and B 1), mamba2-1.3b and whisper-tiny, smoke
  configs on a (data 2, model 2) mesh at length 64, equal the
  reference's compiled ``memory_analysis().argument_size_in_bytes``
  for the same cells (lowered as its ``dryrun.lower_cell`` lowers them,
  in a subprocess with 4 fake CPU devices): the leaves the step reads,
  a decode without the encoder's leaves (whisper) or the position
  (mamba2).
- ``collectives`` and ``flops``: the meta trace of a prefill, a decode
  and a compressed train step (granite smoke on the 2 x 2 mesh; the
  decode of deepseek's too, its MoE routing the whole batch) equal what
  4 gloo ranks of a real grid record running the same steps on the CPU,
  through the same ``RecordingGroup`` and ``FlopCounterMode``, on every
  rank.
- ``params_total``, ``params_active`` and every (arch, shape) cell's
  status and skip reason equal the reference's.
- The CLI writes a cell's JSON, with the reference's keys, under
  ``--out``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.launch import dryrun
from repro_torch.models.registry import model_api

SEQ = 64
# (arch, kind, global batch)
ARG_CELLS = [("granite-3-2b", "prefill", 4), ("granite-3-2b", "decode", 4),
             ("granite-3-2b", "prefill", 1), ("granite-3-2b", "decode", 1),
             ("mamba2-1.3b", "prefill", 4), ("mamba2-1.3b", "decode", 4),
             ("whisper-tiny", "prefill", 4), ("whisper-tiny", "decode", 4)]
# the real grid's cells: (arch, kind, global batch, length)
GRID_CELLS = {"granite_prefill": ("granite-3-2b", "prefill", 4, 32),
              "granite_decode": ("granite-3-2b", "decode", 4, 32),
              "granite_decode_b1": ("granite-3-2b", "decode", 1, 32),
              "deepseek_decode": ("deepseek-moe-16b", "decode", 4, 32),
              "granite_train": ("granite-3-2b", "train", 8, 32)}
PROMPT = 8


def _train_config(arch):
    """The arch's own train settings (compressed, top-k, error feedback,
    ZeRO-1, the block remat) in one microbatch."""
    return dataclasses.replace(get_arch(arch).train, accum_steps=1)


REFERENCE_ARGS = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.configs import get_arch
    from repro.models.registry import model_api
    from repro.serve.steps import (build_decode_step, build_prefill_step,
                                   serve_shardings)

    mesh = make_mesh((2, 2), ("data", "model"))
    out = []
    for arch, kind, B, S in json.loads(sys.argv[1]):
        a = get_arch(arch)
        cfg, prof = a.smoke, a.train.sharding
        api = model_api(cfg)
        sh = serve_shardings(api, prof, mesh, B, S)
        if kind == "prefill":
            fn = build_prefill_step(api, prof, mesh, S)
            batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
            if cfg.family == "encdec":
                batch["frames"] = jax.ShapeDtypeStruct(
                    (B, cfg.enc_seq, cfg.d_model), jnp.float32)
            lowered = jax.jit(fn, in_shardings=(
                sh["params"], {k: sh["batch"] for k in batch})).lower(
                    sh["params_struct"], batch)
        else:
            fn = build_decode_step(api, prof, mesh)
            lowered = jax.jit(
                fn, in_shardings=(sh["params"], sh["batch"], sh["cache"], None),
                out_shardings=(None, sh["cache"]), donate_argnums=(2,)).lower(
                    sh["params_struct"], jax.ShapeDtypeStruct((B,), jnp.int32),
                    sh["cache_struct"], jax.ShapeDtypeStruct((), jnp.int32))
        mem = lowered.compile().memory_analysis()
        out.append(int(mem.argument_size_in_bytes))
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def reference_argument_bytes():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["JAX_PLATFORMS"] = "cpu"
    cells = [[a, k, b, SEQ] for a, k, b in ARG_CELLS]
    res = subprocess.run([sys.executable, "-c", REFERENCE_ARGS,
                          json.dumps(cells)], env=env, check=True,
                         timeout=600, capture_output=True, text=True)
    return dict(zip(ARG_CELLS, json.loads(res.stdout.strip().splitlines()[-1])))


def _meta_trace(arch, kind, B, S):
    a = get_arch(arch)
    mesh = dryrun.RecordingMesh({"data": 2, "model": 2})
    if kind == "train":
        return dryrun.trace_train(model_api(a.smoke), _train_config(arch),
                                  mesh, B, S)
    return dryrun.trace_serve(model_api(a.smoke), a.profile, mesh, kind, B, S)


@pytest.mark.parametrize("cell", ARG_CELLS, ids=lambda c: "-".join(map(str, c)))
def test_argument_bytes_equal_reference_compiled_cells(reference_argument_bytes,
                                                       cell):
    rec = _meta_trace(*cell, SEQ)
    assert rec["memory"]["argument_bytes"] == reference_argument_bytes[cell]


def _grid_rank(mesh, device, cells):
    """Each cell's step on this rank of a real grid: (the recorded
    collectives, the FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.serve import steps as st
    from repro_torch.train.step import build_train_step, init_train_state

    out = {}
    for name, (arch, kind, B, S) in cells.items():
        a = get_arch(arch)
        api = model_api(a.smoke)
        rec = dryrun.RecordingMesh(mesh.shape, mesh=mesh)
        tokens = torch.randint(0, a.smoke.vocab, (B, S), generator=torch.
                               Generator().manual_seed(0))
        if kind == "train":
            tc = dataclasses.replace(_train_config(arch), workers=2)
            state = init_train_state(api, tc, "cpu", group=rec.data,
                                     model=rec.model)
            step = build_train_step(api, tc, group=rec.data, model=rec.model)
            batch = {"tokens": tokens, "labels": tokens.roll(1, 1)}
            with FlopCounterMode(display=False) as fc:
                step(state, batch)
        else:
            params = st.shard_params(api.init(0, "cpu"), a.profile, mesh)
            if kind == "prefill":
                fn = st.build_prefill_step(api, a.profile, rec, S)
                with FlopCounterMode(display=False) as fc:
                    fn(params, {"tokens": tokens})
            else:
                _, cache = st.build_prefill_step(api, a.profile, mesh, S)(
                    params, {"tokens": tokens[:, :PROMPT]})
                fn = st.build_decode_step(api, a.profile, rec)
                with FlopCounterMode(display=False) as fc:
                    fn(params, tokens[:, PROMPT], cache, PROMPT)
        out[name] = (rec.recorder.summary(), fc.get_total_flops())
    return out


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    from repro_torch.launch.ranks import spawn_ranks

    return spawn_ranks(_grid_rank, 4, (GRID_CELLS,), device="cpu",
                       model_parallel=2, threads=1, timeout=300,
                       init_dir=str(tmp_path_factory.mktemp("dryrun_grid")))


@pytest.mark.parametrize("name", list(GRID_CELLS))
def test_meta_collectives_and_flops_equal_a_real_grid(grid, name):
    rec = _meta_trace(*GRID_CELLS[name])
    for r in grid:
        collectives, flops = r[name]
        assert rec["collectives"] == collectives
        assert rec["cost"]["flops"] == flops
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["cost"]["flops"] > 0


def test_counts_and_cell_statuses_equal_reference():
    from repro.configs import SHAPES as J_SHAPES, get_arch as j_get_arch

    assert list(SHAPES) == list(J_SHAPES)
    for name in list_archs():
        a, j = get_arch(name), j_get_arch(name)
        assert a.model.param_count() == j.model.param_count(), name
        assert a.model.active_param_count() == j.model.active_param_count()
        for shape in SHAPES:
            assert a.shape_supported(SHAPES[shape]) == \
                j.shape_supported(J_SHAPES[shape]), (name, shape)


def test_cli_writes_a_cell_record(tmp_path):
    dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    with open(tmp_path / "single" / "granite-3-2b__decode_32k.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec.get("error")
    for key in ("arch", "shape", "mesh", "kind", "seq_len", "global_batch",
                "params_total", "params_active", "aggregator", "memory",
                "cost", "collectives", "trace_s"):
        assert key in rec
    assert (rec["kind"], rec["global_batch"], rec["seq_len"]) == \
        ("decode", 128, 32768)
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["peak_per_device_gib"] > 0
    # over the 16 model ranks: a layer's combine (max, sum, value sum) and
    # its two row-parallel sums, and the embedding's lookup sum
    assert rec["collectives"]["all-reduce"]["group_sizes"] == {"16": 40 * 5 + 1}
    with open(tmp_path / "single" / "granite-3-2b__long_500k.json") as f:
        skip = json.load(f)
    assert skip["status"] == "skip" and skip["reason"].startswith("SKIP")
