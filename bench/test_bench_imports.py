"""What the benchmark's modules load: neither JAX nor the JAX package
(``repro``) nor its benchmarks, compared by whole top-level names; the
program (``repro_torch``) is allowed."""

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

PROBE = """
import importlib.util, json, pathlib, sys
here = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(here), str(here.parent / "src")]
import calibrate, devtrace, harness, modelparts, program_spans, reference, run, yardstick
import refmodels.decoder
import repro_torch.train.step, repro_torch.launch.ranks, repro_torch.kernels.build
for path in sorted((here / "metrics").glob("*.py")):
    harness.load_reader(path)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE, str(HERE)], check=True,
                         capture_output=True, text=True).stdout
    names = set(__import__("json").loads(out.splitlines()[-1]))
    assert "repro_torch" in names and "harness" in names
    assert not names & FORBIDDEN, sorted(names & FORBIDDEN)


def test_sources_import_no_jax():
    for path in sorted(HERE.rglob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0].rstrip(",")
                assert top not in FORBIDDEN, f"{path.name}: {line.strip()}"
