"""chip_smoke.py's helpers on the CPU, the import-free render path, and the
card checks (`gpu` marker: they skip without a GPU; on a GPU machine run
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`)."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from fyp_bidirectionalpathtracer_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_the_cpu(capsys):
    if jax.default_backend() == "gpu":
        chip_smoke.require_gpu()  # accepts the card
        return
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code != 0
    assert "gpu" in capsys.readouterr().err


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in [k for k, _ in calls]


def test_compile_cache_default_is_the_fixed_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_compile_cache")
    assert ("jax_compilation_cache_dir", path) in calls


def test_compare_frames_passes_identical_images():
    img = np.random.RandomState(0).uniform(0, 1, (18, 32, 4))
    res = chip_smoke.compare_frames(img, img.copy())
    assert res["ok"] and res["max_abs_diff"] == 0.0


def test_compare_frames_fails_perturbed_images():
    rs = np.random.RandomState(1)
    ref = rs.uniform(0.2, 0.8, (18, 32, 4))
    # 2 % of pixels moved by O(1): the 99 % pixel criterion fails
    few = ref.copy()
    few[:, :, :3][rs.uniform(size=(18, 32, 3)) < 0.02] += 0.5
    assert not chip_smoke.compare_frames(few, ref)["ok"]
    # every pixel biased by 1 %: the mean criterion fails
    assert not chip_smoke.compare_frames(ref * 1.01, ref)["ok"]
    # a NaN fails
    nan = ref.copy()
    nan[0, 0, 0] = np.nan
    assert not chip_smoke.compare_frames(nan, ref)["ok"]


def test_render_without_flax_or_pillow(tmp_path):
    """The CLI renders and writes its PNG with flax and PIL unimportable."""
    code = (
        "import sys\n"
        "for m in ('flax', 'PIL'): sys.modules[m] = None\n"
        "from fyp_bidirectionalpathtracer_tpu.pipeline import app\n"
        "from fyp_bidirectionalpathtracer_tpu.utils.image import read_png\n"
        f"r = app.main(['--scene', 'cornell', '--width', '16', '--height', "
        f"'12', '--frames', '1', '--outputdir', {str(tmp_path)!r}])\n"
        "img = read_png(r['output'])\n"
        "assert img.shape == (12, 16, 3), img.shape\n"
        "assert 'flax' not in sys.modules or sys.modules['flax'] is None\n"
        "print('OK')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX's default backend is "
                    f"{jax.default_backend()!r})")


@pytest.mark.gpu
def test_gpu_card_matches_host(gpu):
    chip_smoke.phase_card_vs_host(width=128, height=72, frames=2)


@pytest.mark.gpu
def test_gpu_coverage_scenes_render(gpu, tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    chip_smoke.phase_coverage(width=128, height=72)
