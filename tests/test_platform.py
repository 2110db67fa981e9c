"""Platform plumbing: compile-cache placement, exact selection and gathers,
optional dependencies, the native loader build, and the GPU smoke test's
refusal to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import gdslam_tpu
from gdslam_tpu.ops import image as image_ops
from gdslam_tpu.ops import orb as orb_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_update, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update)
    args = code_or_args if isinstance(code_or_args, list) else \
        [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("case", ["env_var", "default", "cpu_only"])
def test_compile_cache_placement(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as JAX reads it, and entries land
    there; unset, the cache is the fixed in-checkout path; CPU-only runs
    keep none."""
    probe = ("import gdslam_tpu, jax; "
             "print(jax.config.jax_compilation_cache_dir)")
    if case == "env_var":
        cache = str(tmp_path / "cache")
        r = _run(probe + "; import jax.numpy as jnp; "
                 "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(3))"
                 ".block_until_ready()",
                 {"JAX_COMPILATION_CACHE_DIR": cache, "JAX_PLATFORMS": "cpu",
                  "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
        assert r.returncode == 0, r.stderr
        assert r.stdout.split()[0] == cache
        assert any(n.startswith("jit_") for n in os.listdir(cache))
    elif case == "default":
        # config only: nothing is compiled, so nothing is written
        r = _run(probe, {"JAX_PLATFORMS": ""},
                 drop=("JAX_COMPILATION_CACHE_DIR",))
        assert r.returncode == 0, r.stderr
        assert r.stdout.split()[0] == os.path.join(REPO, ".jax_cache")
        assert gdslam_tpu.CHECKOUT_CACHE_DIR == os.path.join(REPO,
                                                             ".jax_cache")
    else:
        r = _run(probe, {"JAX_PLATFORMS": "cpu"},
                 drop=("JAX_COMPILATION_CACHE_DIR",))
        assert r.returncode == 0, r.stderr
        assert r.stdout.split()[0] == "None"


def test_top_k_selection_matches_argsort():
    """The local-map candidate budget (pmax=65536 scores, cap=4096) is an
    exact selection: highest score first, ties to the lower index — a
    stable descending argsort."""
    rng = np.random.default_rng(0)
    vis = rng.random(65536) < 0.3
    score = np.where(vis, 1 + rng.integers(0, 8, 65536), 0).astype(np.int32)
    _, ids = jax.lax.top_k(jnp.asarray(score).astype(jnp.float32), 4096)
    ref = np.argsort(-score, kind="stable")[:4096]
    np.testing.assert_array_equal(np.asarray(ids), ref)


@pytest.mark.parametrize("case", ["resize_half", "resize_pyramid",
                                  "patches"])
def test_matmul_gathers_match_direct_gathers(case):
    """The interpolation-matrix resize and the one-hot patch extraction
    against direct-gather numpy references: exact where the arithmetic is
    exact in float32 (a copy, or halving integer pixels), else to float32
    rounding."""
    rng = np.random.default_rng(1)
    if case == "patches":
        img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
        uv = rng.uniform(-10, 90, (64, 2)).astype(np.float32)
        out = np.asarray(orb_ops.extract_patches(jnp.asarray(img),
                                                 jnp.asarray(uv)))
        np.testing.assert_array_equal(
            out, chip_smoke.patches_reference(img, uv, orb_ops.PATCH_EXT))
        return
    img = rng.integers(0, 256, (60, 80)).astype(np.float32)
    h, w = (30, 40) if case == "resize_half" else \
        image_ops.pyramid_shapes(60, 80, 2, 1.2)[1]
    out = np.asarray(image_ops.resize_bilinear(jnp.asarray(img), h, w))
    ref = chip_smoke.resize_reference(img, h, w)
    if case == "resize_half":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=255 * 2.0 ** -20)


@pytest.mark.parametrize("case", ["no_gpu", "outside_checkout"])
def test_chip_smoke_refuses_without_gpu_or_checkout(case, tmp_path):
    """No GPU, or no repository beside the script: a clear message, a
    non-zero exit, and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if case == "outside_checkout":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = _run([sys.executable, script], {"JAX_PLATFORMS": "cpu"}, cwd=cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert ("no GPU" if case == "no_gpu" else "checkout") in r.stderr


def test_core_imports_need_no_optional_packages():
    """The package, System and the TUM CLI import nothing beyond JAX, numpy
    and the declared dependencies: flax (the segmenter extra), PIL and h5py
    load only when a segmenter or an image file is used."""
    r = _run("import sys, gdslam_tpu; "
             "from gdslam_tpu.system.slam import System; "
             "import gdslam_tpu.cli.rgbd_tum; "
             "print(sorted(m for m in ('flax', 'PIL', 'h5py', 'torch') "
             "if m in sys.modules))", {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_segmenter_without_flax_names_the_package():
    r = _run("import sys; sys.modules['flax'] = None; "
             "from gdslam_tpu.models.maskrcnn import build_segmenter",
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "ImportError" in r.stderr and "'flax'" in r.stderr


def test_native_loader_build_failure_reports_stderr(tmp_path, monkeypatch):
    from gdslam_tpu.io import native_loader
    (tmp_path / "build.sh").write_text("echo 'tum_loader.cpp: boom' >&2\n"
                                       "exit 3\n")
    monkeypatch.setattr(native_loader, "_LIB_PATH",
                        str(tmp_path / "libtumloader.so"))
    with pytest.raises(RuntimeError, match="boom"):
        native_loader._load_lib()


@pytest.mark.gpu
def test_parity_on_card(gpu_device):
    """Phase a of chip_smoke.py at the TUM3 settings: extraction,
    descriptors, resize, patches, Hamming and the GD mask on the GPU agree
    with the CPU device and numpy within the smoke test's gates."""
    from gdslam_tpu.config import SlamConfig
    cfg = SlamConfig()
    chip_smoke.phase_parity(
        chip_smoke.Reporter(gpu_device.device_kind), cfg,
        chip_smoke.render_sequence(cfg.camera, (10, 15, 20)))
