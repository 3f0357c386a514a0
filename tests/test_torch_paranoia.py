"""Paranoia mode in the port (model/field.py: PARANOIA, read from
FEATUREBASE_TPU_PARANOIA at import as the JAX package reads it;
ParanoiaError; Field._paranoia_column after set_bit and set_value):
tests/test_safety_rails.py::TestParanoiaMode on the port, and the checks
beside the JAX package's on the same writes."""
import os
import subprocess
import sys

import pytest

from featurebase_tpu.model import field as jfield
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu_torch.model import field as tfield
from featurebase_tpu_torch.model.index import Holder
from torch_twins import twin_namespace

_ns = twin_namespace("test_safety_rails")
TestParanoiaMode = _ns["TestParanoiaMode"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("value,want", [("1", True), ("yes", True),
                                        ("0", False), ("", False)])
def test_read_from_the_environment_at_import(value, want):
    env = dict(os.environ, FEATUREBASE_TPU_PARANOIA=value)
    out = subprocess.run(
        [sys.executable, "-c", "import featurebase_tpu_torch.model.field "
         "as f; print(f.PARANOIA)"], env=env, cwd=ROOT, check=True,
        capture_output=True, text=True).stdout.strip()
    assert out == str(want)


@pytest.mark.parametrize("kind", ["mutex", "bsi"])
def test_writes_raise_where_the_jax_package_raises(kind, monkeypatch):
    """A write after the invariant was broken behind the field's back
    raises ParanoiaError in both packages, with the same message; without
    paranoia both accept it."""
    outs = []
    for mod, holder in ((jfield, JaxHolder), (tfield, Holder)):
        monkeypatch.setattr(mod, "PARANOIA", True)
        idx = holder().create_index("i")
        if kind == "mutex":
            f = idx.create_field("m", mod.FieldOptions(type="mutex"))
            f.set_bit(1, 5)
            f.view("standard").fragment(0).set_bit(7, 5)

            def write():
                # a set_bit elsewhere in the shard checks its own column:
                # column 5 stays broken until written
                f.set_bit(2, 9)
                f.set_bit(3, 5)     # clears rows 1 and 7, then checks
                f.view("standard").fragment(0).set_bit(8, 5)
                f.set_bit(4, 6)
                f._paranoia_column(5)
        else:
            f = idx.create_field("v", mod.FieldOptions(type="int", min=-9,
                                                       max=9))
            f.set_value(3, 5)
            frag = f.view("bsig_v").fragment(0)
            frag.clear_bit(0, 3)          # the exists bit, behind its back

            def write():
                f.set_value(4, 1)
                f._paranoia_column(3)
        with pytest.raises(mod.ParanoiaError) as ei:
            write()
        outs.append(str(ei.value))
        monkeypatch.setattr(mod, "PARANOIA", False)
    assert outs[0] == outs[1]
