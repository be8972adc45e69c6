"""The device lookup, the GPU requirement of measurement paths, the
published-peak table and the compile-cache choice."""

import os
import subprocess
import sys

import jax
import pytest

from spmv_scpa_tpu.bench import roofline
from spmv_scpa_tpu.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_info_reports_the_default_device():
    info = platform.device_info()
    assert info.platform == "cpu"
    assert info.kind == jax.devices("cpu")[0].device_kind
    assert info.count == len(jax.devices("cpu")) == 8
    assert info.as_dict() == {"platform": "cpu", "kind": info.kind,
                              "count": 8}


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_require_gpu_accepts_a_gpu(monkeypatch):
    gpu = platform.DeviceInfo("gpu", "NVIDIA H100 80GB HBM3", 1)
    monkeypatch.setattr(platform, "device_info", lambda: gpu)
    assert platform.require_gpu() is gpu


def test_peak_of_a_known_kind():
    assert roofline.peak_hbm_gbs("NVIDIA H100 80GB HBM3") == 3350.0


def test_peak_of_an_unknown_kind_raises():
    with pytest.raises(KeyError, match="no published HBM peak"):
        roofline.peak_hbm_gbs("NVIDIA A100-SXM4-40GB")


def test_copy_probe_refuses_the_cpu():
    roofline._COPY_BW.clear()
    with pytest.raises(RuntimeError, match="no GPU"):
        roofline.measure_copy_bw(n_bytes=1 << 12, reps=1)


def test_compile_cache_follows_the_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the program sets no other path
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_repo(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = platform.configure_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("stdout, line", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     "NVIDIA H100 80GB HBM3, 700.00 W"),
    ("NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 400.00 W\n",
     "NVIDIA H100 80GB HBM3, 700.00 W; NVIDIA H100 80GB HBM3, 400.00 W"),
])
def test_card_line_is_one_line(monkeypatch, stdout, line):
    def fake_run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        return subprocess.CompletedProcess(cmd, 0, stdout=stdout)
    monkeypatch.setattr(platform.subprocess, "run", fake_run)
    assert platform.gpu_card_line() == line


def _run_script(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    r = _run_script([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    r = _run_script(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_fails_without_a_gpu():
    r = _run_script([os.path.join(REPO, "bench.py")], REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
