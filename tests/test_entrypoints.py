"""Entry-point behaviour off the card: chip_smoke.py and bench.py refuse to
run without a GPU (no silent fallback to the CPU), and the persistent
compilation cache follows JAX_COMPILATION_CACHE_DIR."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, env_over=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_over or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_chip_smoke_fails_without_gpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path,
               env_over={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_fails_without_gpu():
    out = _run(["bench.py", "--configs", "hadamard", "--smoke"])
    assert out.returncode != 0
    assert "no GPU" in out.stdout


_CACHE_PROBE = (
    "import jax; from quantumcollocation_tpu.utils.compile_cache import "
    "enable_persistent_cache as e; d = e(); "
    "print(d); print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_follows_env(tmp_path):
    out = _run(["-c", _CACHE_PROBE],
               env_over={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_default_is_fixed_repo_path():
    out = _run(["-c", _CACHE_PROBE])
    assert out.returncode == 0, out.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.split() == [want, want]
