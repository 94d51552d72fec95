"""Executable-documentation enforcement: every examples/*.py runs green.

The reference ships literate, CI-executed examples
(/root/reference/docs/literate/man/*.jl, built by
/root/reference/.github/workflows/CI.yml:40-60); this is the equivalent
guarantee for this repo's examples/ — each runs as a fresh subprocess on
the CPU backend and must exit 0 (examples assert their own behavioral
claims internally: fidelity improvement, duration decrease, robustness
ordering).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(
    f
    for f in os.listdir(os.path.join(REPO, "examples"))
    if f.endswith(".py")
)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    # pin the CPU with a config update BEFORE the example body executes —
    # runpy keeps __name__ == "__main__" semantics
    path = os.path.join(REPO, "examples", name)
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import runpy; runpy.run_path(%r, run_name='__main__')" % path
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=900,
        env=dict(os.environ),
        cwd=REPO,
    )
    assert out.returncode == 0, (
        f"{name} failed:\n{out.stdout[-1000:]}\n{out.stderr[-1500:]}"
    )
