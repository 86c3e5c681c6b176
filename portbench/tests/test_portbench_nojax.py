"""After a rehearsal of each cell on the CPU, in a fresh interpreter, no
loaded module's top-level name is JAX's or the JAX package's (the
port's name begins with the JAX package's, so names are compared whole)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL

CODE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from portbench import harness
out = harness.run_cell({cell!r}, 3, 0.1, False, torch.device("cpu"),
                       overrides=json.loads({small!r}))
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps({{"correct": out["correct"], "tops": tops,
                  "forbidden": harness.loaded_forbidden()}}))
"""


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_cell_loads_no_jax(cell):
    code = CODE.format(root=str(ROOT), cell=cell,
                       small=json.dumps(SMALL[cell]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "matchinglib_poselib_torch" in res["tops"]
    assert not set(res["tops"]) & {"jax", "jaxlib", "flax",
                                   "matchinglib_poselib_tpu"}
    assert res["forbidden"] == []
