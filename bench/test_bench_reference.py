"""The plain reference held to the program (``repro_torch``) on the CPU
at small sizes of both configurations: the loss and every gradient of
one worker, then the three checked steps through the compressed
aggregator. The only file of the benchmark that imports both."""

import copy
import json
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402
import reference as ref_lib  # noqa: E402
import refmodels  # noqa: E402
import yardstick as ys  # noqa: E402

MANIFEST = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def small(workload, dtype="float32"):
    """The cell's files with the model cut to a CPU size (widths too: only
    the tests run at it) and the mix to 4 x 64 tokens."""
    files = harness.cell_files(MANIFEST, workload)
    cfg = copy.deepcopy(files["config"])
    cfg.update(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=500, q_block=32,
               dtype=dtype, n_kv_heads=2 if cfg["family"] == "dense" else 4)
    if cfg.get("moe"):
        cfg["moe"].update(num_experts=8, top_k=2, expert_d_ff=64)
    mix = copy.deepcopy(files["mix"])
    mix.update(global_batch=4, seq_len=64)
    mix["compression"]["bucket_bytes"] = 4 * 30720
    files.update(config=cfg, mix=mix)
    return files


WORKLOADS = [c["name"] for c in MANIFEST["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_loss_and_gradients_equal_the_program(workload):
    from repro_torch.models.params import ParamTree, unflatten_tree
    from repro_torch.models.registry import model_api
    files = small(workload)
    cfg, mix = files["config"], files["mix"]
    mcfg, tc = harness.program_configs(cfg, mix, 7)
    params = ref_lib.make_params(cfg, 7, "cpu")
    tree = ParamTree(unflatten_tree([(tuple(p.split("/")), t.clone()) for p, t in params.items()]))
    assert [("/".join(p)) for p in tree.paths] == list(params)
    ref_init = model_api(mcfg).init(0, "cpu")
    assert [tuple(p.shape) for p in ref_init.leaves()] == [tuple(t.shape) for t in params.values()]
    batch = ref_lib.make_batches(cfg, 2, mix["seq_len"], 7, [0])[0]
    loss, _ = model_api(mcfg).loss(tree.tree(), batch, remat="block")
    grads = torch.autograd.grad(loss, tree.leaves())
    P = {p: t.clone().requires_grad_() for p, t in params.items()}
    ref = refmodels.for_config(cfg).loss_fn(P, cfg, batch["tokens"], batch["labels"])
    rgrads = torch.autograd.grad(ref, list(P.values()))
    assert abs(float(loss.detach()) - float(ref.detach())) < 1e-5 * float(ref.detach())
    for path, g, r in zip(params, grads, rgrads):
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-6 * float(r.abs().max())), path


@pytest.mark.parametrize("workload", WORKLOADS)
def test_checked_steps_equal_the_program(workload):
    """In f32 the reference's three steps (top-k with error feedback, the
    mean, clipping, AdamW) read the program's to rounding; the peel
    leaves nothing, and the bytes the program hands the group's
    reductions a step are the yardstick's sketch and bitmap and the mean
    of the loss and its three terms (16 B)."""
    files = small(workload)
    part = harness.run_cell(files["config"], files["mix"], files["limits"], 2**31 + 5,
                            0.5, True, "cpu")
    r = part["readings"]
    assert r["residual_share"]["value"] == 0.0
    comp = files["mix"]["compression"]
    blocks = ys.codec_geometry(ys.param_count(files["config"]), comp)["blocks"]
    assert part["wire_bytes"] == part["steps"] * (ys.wire_bytes(blocks, comp) + 16)
    assert r["loss_gap"]["value"] < 1e-5
    assert r["grad_gap"]["value"] < 1e-4, r
    assert r["change_gap"]["value"] < 1e-3, r
