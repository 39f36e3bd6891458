"""A run of a tiny cell loads nothing of JAX or of the JAX package, in
its own process and in each rank a multi-rank cell spawns."""
from __future__ import annotations

import subprocess
import sys
import types

from conftest import ROOT

HEAD = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from flowbench import run
"""

SINGLE = HEAD + """
line, _ = run.execute(tiny_cell("gen4hd.replay"), 7, 0.5, False, "cpu")
assert line["correct"], line
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""

RANKS = HEAD + """
from flowbench.drivers import replay
import test_flowbench_imports as t
cell = tiny_cell("gen4hd-halo4.replay")
cell.config["devices"] = 2
line, _ = run.execute(cell, 7, 0.5, False, "cpu")
assert line["correct"], line
replay.run = t.ranks_loading_jax
try:
    run.execute(cell, 7, 0.5, False, "cpu")
    print("no error")
except RuntimeError as e:
    print(str(e).replace(chr(10), " "))
print(run.forbidden_modules())
"""


def _rank_loading_jax(cell, seed, seconds, trace, device_type):
    """A rank of the replay driver in which a module named `jax` is
    loaded by the time its window closes."""
    from flowbench.drivers import replay
    from farms_tpu_torch.parallel import mesh
    if mesh.rank_and_size()[0] == 1:
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    return replay._rank(cell, seed, seconds, trace, device_type)


def ranks_loading_jax(cell, seed, seconds, trace, device_type):
    from farms_tpu_torch.parallel import mesh
    return mesh.run(_rank_loading_jax, 2, device_type, cell, seed, seconds,
                    trace, device_type)


def _script(body: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", body.format(
            root=str(ROOT), tests=str(ROOT / "flowbench" / "tests"))],
        capture_output=True, text=True, timeout=600, check=True).stdout
    return out.strip().splitlines()


def test_flowbench_run_loads_no_jax():
    top, found = _script(SINGLE)[-2:]
    assert found == "[]"
    assert "'farms_tpu_torch'" in top
    for name in ("jax", "jaxlib", "flax", "farms_tpu"):
        assert f"'{name}'" not in top


def test_flowbench_ranks_are_checked_for_jax():
    """The 2-rank halo cell runs correct with nothing loaded; a rank that
    loads `jax` makes the run fail, naming the rank, though the parent
    process never loads it."""
    error, found = _script(RANKS)[-2:]
    assert found == "[]"
    assert "rank 1: jax" in error and "rank 0" not in error, error
