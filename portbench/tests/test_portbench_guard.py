"""No run loads JAX or the JAX package, compared by whole top-level
names, and the reference imports nothing of the program."""
import subprocess
import sys

from portbench import run

from portbench import spec


def test_banned_names_are_whole_top_level_names(monkeypatch):
    for name in ("featurebase_tpu_torch", "featurebase_tpu_torch.ops",
                 "jaxtyping", "flaxen", "portbench"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.banned_modules() == [] or \
        set(run.banned_modules()) <= {"jax", "jaxlib", "flax",
                                      "featurebase_tpu"}
    before = set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "featurebase_tpu.model", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(run.banned_modules()) == before | {"featurebase_tpu",
                                                  "jaxlib"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_modules_load_no_jax():
    mods = ["portbench.run", "portbench.load", "portbench.loop",
            "portbench.trace", "portbench.control", "portbench.compare",
            "portbench.reference.answers", "featurebase_tpu_torch.server.api"]
    loaded = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert not loaded & set(run.BANNED)


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.answers")
    assert "featurebase_tpu_torch" not in loaded
    assert not loaded & set(run.BANNED)
