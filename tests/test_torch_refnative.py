"""``tests/torch_refnative.py`` against the build race of the reference's
native loader: six processes start at once on a copy of
``linops_tpu/native/`` with no library built, each imports the copy under
another name and runs the helper, and every one of them must end with
``native_available()`` True. The repository's own ``linops_tpu/native/`` is
not touched."""

import os
import shutil
import subprocess
import sys

import linops_tpu.native as ref_native

PROCESSES = 6
ROUNDS = 2  # each on a fresh copy
HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import importlib.util, os, sys
sys.path.insert(0, {tests!r})
from torch_refnative import ensure_reference_native
path = {copy!r}
spec = importlib.util.spec_from_file_location(
    "refnative_copy", os.path.join(path, "__init__.py"), submodule_search_locations=[path])
mod = importlib.util.module_from_spec(spec)
sys.modules["refnative_copy"] = mod
spec.loader.exec_module(mod)
ensure_reference_native(mod)
print("available", mod.native_available(), mod._load_clos() is not None, flush=True)
"""


def test_six_processes_all_load_a_fresh_copy(tmp_path):
    src = os.path.dirname(os.path.abspath(ref_native.__file__))
    for r in range(ROUNDS):
        copy = tmp_path / f"native_{r}"
        copy.mkdir()
        for name in ("__init__.py", "bsr_pack.cpp", "clos_route.cpp"):
            shutil.copy(os.path.join(src, name), copy / name)
        assert not [f for f in os.listdir(copy) if f.endswith(".so")]
        code = CHILD.format(tests=HERE, copy=str(copy))
        procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(PROCESSES)]
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-2000:]
            assert out.strip().splitlines()[-1] == "available True True", (out, err[-2000:])
        built = sorted(f for f in os.listdir(copy) if f.endswith(".so"))
        assert len(built) == 2 and all(".tmp." not in f for f in built), built
