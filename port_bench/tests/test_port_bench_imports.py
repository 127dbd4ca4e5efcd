"""What the benchmark loads: the reference imports nothing of the port,
and the check for JAX compares top-level module names whole."""
import pathlib
import subprocess
import sys

from port_bench import core

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=120)
    return set(out.stdout.split())


def test_reference_imports_nothing_of_the_port():
    mods = _modules_after(
        "from port_bench import core\n"
        "for kind in ('reference', 'traffic'):\n"
        "    for f in sorted((core.BENCH_DIR / kind).glob('[!_]*.py')):\n"
        "        core.load_module(kind, f.stem)")
    assert "event_representation_study_tpu_torch" not in mods
    assert not mods & set(core.FORBIDDEN)


def test_harness_and_drivers_import_no_jax():
    mods = _modules_after(
        "import port_bench.run, port_bench.core\n"
        "from port_bench import core\n"
        "import port_bench.controls\n"
        "for f in sorted((core.BENCH_DIR / 'drivers').glob('[!_]*.py')):\n"
        "    core.load_module('drivers', f.stem)\n"
        "import event_representation_study_tpu_torch.train.engine, "
        "event_representation_study_tpu_torch.cli.infer, "
        "event_representation_study_tpu_torch.train.classifier")
    assert "event_representation_study_tpu_torch" in mods
    assert not mods & set(core.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "event_representation_study_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "event_representation_study_tpu", raising=False)
    assert "event_representation_study_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "event_representation_study_tpu.reps", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert core.forbidden_modules() == ["event_representation_study_tpu", "jax"]
