"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: `neurofluid_torch` begins with the letters of
`neurofluid_tpu`."""

import subprocess
import sys

from nfbench import harness
from nfbench.tests.conftest import ROOT

HARNESS = ["nfbench.run", "nfbench.harness", "nfbench.readings",
           "nfbench.cells", "nfbench.trace", "nfbench.work", "nfbench.inputs"]
REFERENCE = ["nfbench.reference.particle_net", "nfbench.reference.render_net",
             "nfbench.reference.train", "nfbench.reference.precision"]


def top_level_after(imports, also=""):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports) + also
            + "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_harness_and_program_import_no_jax():
    readers = "".join(
        f"harness.load_reader(pathlib.Path('.'), '{p.stem}')\n"
        for p in (ROOT / "nfbench/metrics").glob("*.py"))
    readers += "".join(
        f"harness.load_entry(pathlib.Path('.'), '{p.stem}')\n"
        for p in (ROOT / "nfbench/entries").glob("*.py"))
    names = top_level_after(
        HARNESS + ["pathlib", "neurofluid_torch.train.transition",
                   "neurofluid_torch.train.e2e",
                   "neurofluid_torch.train.warmup",
                   "neurofluid_torch.train.trainer_base"],
        "from nfbench import harness\n" + readers)
    assert "neurofluid_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    names = top_level_after(REFERENCE)
    assert not names & ({"neurofluid_torch"} | set(harness.FORBIDDEN))


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "neurofluid_torch_x", sys)
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "neurofluid_tpu.models", sys)
    assert "neurofluid_tpu" not in before
    assert "neurofluid_tpu" in harness.forbidden_modules()
