"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BANNED = ("jax", "jaxlib", "flax", "tracer")


def _modules(code: str) -> list:
    """The top-level names of sys.modules after `code` runs in a fresh
    interpreter at the repo's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _harness_imports() -> str:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    lines = ["import importlib", "from portbench import core, run, check, "
             "trace, rooflines, camera_path",
             "from portbench.drivers import render, train, render_sharded",
             "import portbench.reference.render, "
             "portbench.reference.integrator, portbench.reference.scene",
             "import tracer_torch.render.renderer, tracer_torch.train, "
             "tracer_torch.dist.multihost"]
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        lines.append(f"importlib.import_module('portbench.scenes."
                     f"{cfg['scene']}')")
    for w in bench["workloads"]:
        lines.append(f"core.load_cell({w['name']!r})")
        lines.append(f"core.driver(core.load_cell({w['name']!r}))")
    for m in bench["per_layer"]:
        lines.append(f"core.metric_reader({m['name']!r})")
    return "\n".join(lines)


def test_top_level_names_are_compared_whole():
    names = {"tracer_torch", "tracerx", "jaxtyping"}
    assert not names & set(BANNED)


def test_nothing_the_harness_runs_imports_jax():
    mods = _modules(_harness_imports())
    assert "portbench" in mods and "tracer_torch" in mods
    assert not set(mods) & set(BANNED), sorted(set(mods) & set(BANNED))


def test_the_reference_imports_nothing_of_the_port():
    mods = _modules("import portbench.reference.render, "
                    "portbench.reference.integrator, "
                    "portbench.reference.scene, portbench.check")
    assert "tracer_torch" not in mods
    assert not set(mods) & set(BANNED)
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        src = path.read_text()
        assert "import tracer" not in src and "from tracer" not in src, path
