"""A configuration's model comes from the reference module that its file
names (``bench/refmodels``): the decoder module gives both
configurations' parameters and checked steps bit for bit as the
benchmark gave them before the module was split out (digests recorded
from that tree at the CPU test size); a configuration that names another
module is served from it through ``cell_files``, ``make_params``,
``train_readings``, ``mfu``'s count and the codec's stream size; the
program's sub-configurations are built from the file's dicts by their
field's type; and every existing per-layer reader reads, on a traced
run's record saved from that tree's card run, what that tree's readers
read from it."""

import copy
import hashlib
import json
import math
import pathlib
import sys
import types

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402
import modelparts  # noqa: E402
import reference as ref_lib  # noqa: E402
import refmodels  # noqa: E402
import yardstick as ys  # noqa: E402
from test_bench_reference import MANIFEST, WORKLOADS, small  # noqa: E402

# at ``small(workload)``'s sizes, seed 7: the leaves' bytes, and the
# float.hex of every reading of ``train_readings`` in f32 and as the
# fp8 control, from the tree whose ``reference.py`` held the decoder
DIGESTS = {
    "train.granite-3-2b.d4.w2": {
        "params": "f88060ca65ba34e471e9d7ccb1a87739e1aa89dd0afeaf14e1f59744028c3d7c",
        "f32": "10b30920d9c90f486849bf4fcc4c48d8403deb8c4c59165d51d3c83c207d6559",
        "fp8": "147c821fcc50de8ab4f03e66815434a6621294f85dbc03063c18ca3081d2dc6f"},
    "train.deepseek-moe-16b.d1.w2": {
        "params": "6bf838c647ad458ed67c3390ec09d90f553fae12781a2e1e6be9626d980580cd",
        "f32": "7a54f95f69d622fcd2f6b142ed4261c14b57a5dbf4f125755b2505c34537eb21",
        "fp8": "3364cde9747de301a278172dbe5e41820b1237f3f0aa32de5b256f2feb03085a"},
}
RECORDS = HERE / "testdata"


def _params_digest(params) -> str:
    h = hashlib.sha256()
    for path, t in params.items():
        h.update(path.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _readings_digest(readings) -> str:
    exact = {k: [x.hex() if isinstance(x, float) else x for x in v]
             for k, v in readings.items()}
    return hashlib.sha256(json.dumps(exact).encode()).hexdigest()


@pytest.mark.parametrize("workload", sorted(DIGESTS))
def test_decoder_module_keeps_the_parameters_and_readings(workload):
    files = small(workload)
    cfg, mix = files["config"], files["mix"]
    assert refmodels.for_config(cfg).__name__ == "refmodels.decoder"
    want = DIGESTS[workload]
    assert _params_digest(ref_lib.make_params(cfg, 7, "cpu")) == want["params"]
    batches = ref_lib.make_batches(cfg, mix["global_batch"], mix["seq_len"], 7,
                                   range(mix["check_steps"]))
    for prec in ("f32", "fp8"):
        got = ref_lib.train_readings(cfg, mix, 7, batches, "cpu", prec=prec)
        assert _readings_digest(got) == want[prec], prec


# ----------------------------------------------------------------------
# A configuration that names a module of its own
# ----------------------------------------------------------------------

def _toy_module():
    """A bigram model: an embedding and an output matrix, one product."""
    mod = types.ModuleType("refmodels.toy")

    def layout(cfg):
        V, D = cfg["vocab"], cfg["d_model"]
        return [("embed", (V, D), torch.float32, D), ("out", (D, V), torch.float32, D)]

    def loss_fn(P, cfg, tokens, labels, prec="f32"):
        logits = modelparts.mm(P["embed"][tokens], P["out"], prec)
        return torch.nn.functional.cross_entropy(logits.flatten(0, 1), labels.flatten())

    mod.layout = layout
    mod.loss_fn = loss_fn
    mod.matmul_params_per_token = lambda cfg: cfg["d_model"] * cfg["vocab"]
    mod.attention_flops_per_token = lambda cfg, seq_len: 0
    return mod


def _cell_files_with(cfg: dict, path: pathlib.Path) -> dict:
    """The first cell's files with its configuration ``cfg``, written to
    ``path``."""
    path.write_text(json.dumps(cfg))
    manifest = copy.deepcopy(MANIFEST)
    cell = manifest["workloads"][0]
    for c in manifest["configs"]:
        if c["name"] == cell["config"]:
            c["file"] = str(path)
    return harness.cell_files(manifest, cell["name"])


def test_a_configuration_brings_its_own_module(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "refmodels.toy", _toy_module())
    files = _cell_files_with({"arch": "toy", "reference": "toy", "vocab": 300, "d_model": 48},
                             tmp_path / "toy.json")
    files["mix"].update(global_batch=4, seq_len=16)
    cfg, mix = files["config"], files["mix"]
    assert cfg["reference"] == "toy"
    params = ref_lib.make_params(cfg, 3, "cpu")
    assert {p: tuple(t.shape) for p, t in params.items()} == \
        {"embed": (300, 48), "out": (48, 300)}
    assert float(params["out"].abs().max()) <= 1 / math.sqrt(48)
    batches = ref_lib.make_batches(cfg, 4, 16, 3, range(mix["check_steps"]))
    got = ref_lib.train_readings(cfg, mix, 3, batches, "cpu")
    assert got["paths"] == ["embed", "out"] and len(got["losses"]) == mix["check_steps"]
    assert abs(got["losses"][0] - math.log(300)) < 0.1
    assert all(c > 0 for c in got["change"])
    # the stream the codec sends and the model FLOPs behind ``mfu``
    assert ys.param_count(cfg) == 2 * 300 * 48
    assert ys.train_flops_per_token(cfg, 16) == 6 * 48 * 300
    mfu = harness.load_reader(HERE / "metrics" / "mfu.py")
    run = {"cfg": cfg, "mix": mix, "steps": 10, "tokens_per_step": 64, "window_s": 1.0,
           "chips": 1}
    assert mfu.read(run) == 100.0 * 6 * 48 * 300 * 64 * 10 / ys.BF16_FLOPS
    blocks = ys.codec_geometry(2 * 300 * 48, mix["compression"])["blocks"]
    least = ys.least_ms(ys.codec_bytes(blocks, mix["compression"])["producer"]) * 1e-3
    # one step of W 2 workers: two producer launches' least time, taken
    run["profile"] = {"steps": 1, "kernels": {"wire_encode_kernel": [2 * least]}}
    assert ys.kernel_roofline_pct(run, "wire_encode_kernel", "producer") == \
        pytest.approx(100.0)


def test_a_missing_module_fails_before_the_run(tmp_path):
    with pytest.raises(ModuleNotFoundError, match="no_such_model"):
        _cell_files_with({"arch": "toy", "reference": "no_such_model"}, tmp_path / "toy.json")


# ----------------------------------------------------------------------
# The program's configuration
# ----------------------------------------------------------------------

def test_program_configs_build_every_sub_config():
    from repro_torch.models.config import MoEConfig, SSMConfig
    files = harness.cell_files(MANIFEST, WORKLOADS[0])
    cfg = dict(files["config"], family="ssm", reference="decoder",
               ssm={"d_state": 64, "expand": 2, "head_dim": 32, "d_conv": 4, "chunk": 128})
    mcfg, _ = harness.program_configs(cfg, files["mix"], 1)
    assert mcfg.ssm == SSMConfig(d_state=64, expand=2, head_dim=32, d_conv=4, chunk=128)
    assert mcfg.moe is None
    deepseek = harness.cell_files(MANIFEST, "train.deepseek-moe-16b.d1.w2")
    mcfg, _ = harness.program_configs(deepseek["config"], deepseek["mix"], 1)
    assert isinstance(mcfg.moe, MoEConfig) and mcfg.moe.num_experts == 64


# ----------------------------------------------------------------------
# The readers on a traced run's record
# ----------------------------------------------------------------------

READERS = ["mfu", "device_idle_pct", "forward_ms", "collective_ms", "wire_bytes",
           "wire_encode_roofline", "wire_peel_roofline"]


@pytest.mark.parametrize("record", sorted(p.name for p in RECORDS.glob("run.*.json")))
def test_readers_read_a_recorded_run_as_before(record):
    """``run``: what a traced run of the cell handed the readers on the
    card (its kernel times trimmed to the wire kernels); ``read``: what
    the readers of the tree it ran on read from it, to the last digit."""
    saved = json.loads((RECORDS / record).read_text())
    assert set(saved["read"]) == set(READERS)
    for name in READERS:
        reader = harness.load_reader(HERE / "metrics" / f"{name}.py")
        assert reader.read(saved["run"]) == saved["read"][name], name
    for name in ("backward_ms", "aggregate_ms", "sparsify_ms", "optimizer_ms",
                 "collective_calls"):
        assert harness.load_reader(HERE / "metrics" / f"{name}.py").read(saved["run"]) is None
