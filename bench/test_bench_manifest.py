"""``BENCHMARK.json`` against the files of the benchmark: every cell's
configuration, mix, limits and readers found by name, names and units in
the allowed characters, each per-layer metric moving an end-to-end
metric its cells report; and the rank plumbing (the spawn, each rank's
step clock, rank 0's line, the peak over the ranks, the refusal where a
rank loaded JAX) on gloo ranks on the CPU at a small size."""

import copy
import json
import pathlib
import re
import sys
import time
import types

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402

MANIFEST = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in MANIFEST["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    files = harness.cell_files(MANIFEST, workload)
    assert files["config"]["reduced"] == [c for c in MANIFEST["configs"]
                                          if c["name"] == files["cell"]["config"]][0]["reduced"]
    assert set(files["limits"]) == {"loss_gap", "grad_gap", "change_gap", "residual_share"}
    for name, path in files["readers"].items():
        reader = harness.load_reader(path)
        assert UNIT.match(reader.UNIT) and callable(reader.read), name
    # emulated workers share one card; ranks take a card each
    assert files["mix"]["ranks"] in (1, files["cell"]["chips"])


def test_names_and_units():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in MANIFEST["configs"]]
    names += [c["traffic"] for c in MANIFEST["workloads"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for path in HERE.rglob("*"):
        rel = path.relative_to(HERE.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS), (m["name"], cell)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def _small_rank_files():
    files = harness.cell_files(MANIFEST, CELLS[0])
    cfg = copy.deepcopy(files["config"])
    cfg.update(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab=300,
               q_block=16, dtype="float32")
    mix = copy.deepcopy(files["mix"])
    mix.update(global_batch=4, seq_len=16, ranks=2, workers=2)
    mix["compression"]["bucket_bytes"] = 4 * 30720
    files.update(config=cfg, mix=mix)
    return files


def test_ranks_on_gloo():
    from repro_torch.launch.ranks import spawn_ranks
    files = _small_rank_files()
    t0 = time.time()
    parts = spawn_ranks(harness.rank_main, 2, (files, 2**31 + 77, 1.0, False, t0),
                        device="cpu", timeout=240, threads=1)
    assert [p["rank0"] for p in parts] == [True, False]
    assert len(parts[0]["step_s"]) == len(parts[1]["step_s"]) >= 1
    assert all(p["window_s"] >= 1.0 for p in parts)
    assert "readings" in parts[0] and "readings" not in parts[1]
    parts[1]["peak_bytes"] = 123
    line = harness.result_line(parts, files, False, 2, "cpu")
    assert line["device"]["memory_peak_bytes"] == 123 and line["device"]["count"] == 2
    assert line["correct"] and list(line)[-1] == "check"
    assert line["metrics"]["tokens_per_s"]["value"] == pytest.approx(
        parts[0]["steps"] * 4 * 16 / parts[0]["window_s"])
    assert 0 < line["metrics"]["setup_s"]["value"] < time.time() - t0


def _rank_loading_jax(group, device, *args):
    """A rank that finds ``jax`` in its modules (planted: an entry under
    the name is what the check reads) on rank 1, then runs as any."""
    if group.first_worker == 1:
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    return harness.rank_main(group, device, *args)


def test_ranks_refuse_a_rank_that_loaded_jax():
    from repro_torch.launch.ranks import spawn_ranks
    files = _small_rank_files()
    parts = spawn_ranks(_rank_loading_jax, 2, (files, 2**31 + 78, 0.3, False, time.time()),
                        device="cpu", timeout=240, threads=1)
    assert parts[0]["loaded"] == [] and parts[1]["loaded"] == ["jax"]
    with pytest.raises(harness.ForbiddenModules, match="jax"):
        harness.result_line(parts, files, False, 2, "cpu")
