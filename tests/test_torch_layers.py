"""Port parity at the layer level: configs, the weight bridge, the nn
primitives and the LED product, each held against the JAX package on the
same numpy inputs (fp32 on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.kernels.ops import led_matmul as jax_led_matmul
from repro.kernels.ref import led_matmul_ref
from repro.models import build_model
from repro.nn import embedding as jemb
from repro.nn import linear as jlin
from repro.nn import mlp as jmlp
from repro.nn import norm as jnorm
from repro.nn import rotary as jrot
from repro.nn.module import named_parameters as jax_named_parameters

import repro_torch.configs as tcfg
from repro_torch import bridge
from repro_torch.kernels.led_matmul import led_matmul, led_matmul_torch
from repro_torch.nn.embedding import Embedding
from repro_torch.nn.linear import LED, Linear
from repro_torch.nn.mlp import SwiGLU
from repro_torch.nn.norm import RMSNorm
from repro_torch.nn.rotary import apply_rope

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, different summation order


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---- configs ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jcfg._MODULES))
def test_configs_equal_field_for_field(name):
    j, t = jcfg.get_config(name), tcfg.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    if j.n_heads:  # ssm configs have no attention heads
        assert t.resolved_head_dim == j.resolved_head_dim
    assert tcfg.applicable_shapes(t) == jcfg.applicable_shapes(j)


def test_config_registry_and_shapes_match():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()})
    with pytest.raises(ValueError, match="unknown arch"):
        tcfg.get_config("nope")


# ---- bridge -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips(dtype):
    """JAX params -> port model -> JAX-layout names: same paths, shapes,
    dtype and bits (bf16 moved as its 16-bit patterns)."""
    cfg = jcfg.get_config("qwen2.5-3b").reduced().replace(dtype=dtype)
    jmodel = build_model(jax.random.PRNGKey(3), cfg)
    params = {k: np.asarray(v) for k, v in jax_named_parameters(jmodel)}
    assert any(v.dtype.name == dtype for v in params.values())
    port = bridge.from_jax(params, tcfg.get_config("qwen2.5-3b").reduced()
                           .replace(dtype=dtype), device="cpu")
    back = dict(bridge.named_parameters(port))
    assert set(back) == set(params)
    for k, v in params.items():
        t = back[k]
        assert tuple(t.shape) == v.shape, k
        assert str(t.dtype) == f"torch.{v.dtype.name}", k
        if dtype == "bfloat16":
            bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(bits, v.view(np.uint16), err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), v, err_msg=k)


def test_bridge_to_tensor_keeps_bf16_bits_and_copies():
    arr = np.array([1.0, -2.5, 3.140625], dtype=ml_dtypes.bfloat16)
    t = bridge.to_tensor(arr)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
    ro = np.arange(4, dtype=np.float32)
    ro.setflags(write=False)  # jax arrays come back read-only
    t2 = bridge.to_tensor(ro)
    t2[0] = 7.0
    assert ro[0] == 0.0


# ---- nn primitives -------------------------------------------------------------


def test_rmsnorm_matches_jax():
    rng = _rng(1)
    x, scale = _f32(rng, 3, 5, 64), _f32(rng, 64)
    ref = jnorm.RMSNorm(scale=jnp.asarray(scale))(jnp.asarray(x))
    n = RMSNorm(64)
    n.scale.data.copy_(_t(scale))
    np.testing.assert_allclose(n(_t(x)).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_jax(theta):
    rng = _rng(2)
    x = _f32(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    ref = jrot.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    out = apply_rope(_t(x), _t(pos), theta=theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_embedding_and_attend_match_jax():
    rng = _rng(3)
    w = _f32(rng, 50, 32)
    toks = rng.integers(0, 50, (2, 6)).astype(np.int32)
    x = _f32(rng, 2, 6, 32)
    je = jemb.Embedding(weight=jnp.asarray(w))
    te = Embedding(_t(w))
    np.testing.assert_array_equal(te(_t(toks).long()).numpy(),
                                  np.asarray(je(jnp.asarray(toks))))
    np.testing.assert_allclose(te.attend(_t(x)).numpy(),
                               np.asarray(je.attend(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_jax(bias):
    rng = _rng(4)
    w, b, x = _f32(rng, 48, 40), _f32(rng, 40), _f32(rng, 3, 48)
    jl = jlin.Linear(weight=jnp.asarray(w),
                     bias=jnp.asarray(b) if bias else None)
    tl = Linear(_t(w), _t(b) if bias else None)
    np.testing.assert_allclose(tl(_t(x)).numpy(),
                               np.asarray(jl(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("jax_fuse", ["jnp", "pallas"])
def test_led_torch_matches_jax_led(jax_fuse):
    """LED(fuse='torch') against the JAX LED on its plain path and on its
    Pallas kernel (interpret mode on the CPU)."""
    rng = _rng(5)
    a, b = _f32(rng, 64, 12, scale=0.1), _f32(rng, 12, 40, scale=0.3)
    bias, x = _f32(rng, 40), _f32(rng, 2, 5, 64)
    jl = jlin.LED(A=jnp.asarray(a), B=jnp.asarray(b), bias=jnp.asarray(bias),
                  fuse=jax_fuse)
    tl = LED(_t(a), _t(b), _t(bias), fuse="torch")
    np.testing.assert_allclose(tl(_t(x)).numpy(),
                               np.asarray(jl(jnp.asarray(x))), **TOL)


def test_swiglu_matches_jax():
    rng = _rng(6)
    wg, wu, wd = _f32(rng, 32, 64, scale=0.2), _f32(rng, 32, 64, scale=0.2), \
        _f32(rng, 64, 32, scale=0.2)
    x = _f32(rng, 2, 3, 32)
    jm = jmlp.SwiGLU(gate_proj=jlin.Linear(weight=jnp.asarray(wg), bias=None),
                     up_proj=jlin.Linear(weight=jnp.asarray(wu), bias=None),
                     down_proj=jlin.Linear(weight=jnp.asarray(wd), bias=None))
    tm = SwiGLU(Linear(_t(wg)), Linear(_t(wu)), Linear(_t(wd)))
    np.testing.assert_allclose(tm(_t(x)).numpy(),
                               np.asarray(jm(jnp.asarray(x))), **TOL)


# ---- the LED product --------------------------------------------------------

LED_SHAPES = [
    ((1, 128), 16, 128),       # single row (decode-like)
    ((8, 64), 4, 48),          # smaller than any block
    ((100, 300), 17, 130),     # ragged on every dim
    ((2, 3, 64), 1, 96),       # leading axes, rank 1
    ((33, 77), 9, 65),         # odd everything
]


@pytest.mark.parametrize("xshape,r,n", LED_SHAPES)
def test_led_matmul_torch_matches_jax_kernel_and_oracle(xshape, r, n):
    rng = _rng(7)
    k = xshape[-1]
    x = _f32(rng, *xshape)
    a, b = _f32(rng, k, r, scale=k ** -0.5), _f32(rng, r, n, scale=r ** -0.5)
    out = led_matmul_torch(_t(x), _t(a), _t(b)).numpy()
    ref = np.asarray(led_matmul_ref(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(b)))
    kern = np.asarray(jax_led_matmul(jnp.asarray(x), jnp.asarray(a),
                                     jnp.asarray(b)))  # interpret on CPU
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, kern, **TOL)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(led_matmul(_t(x), _t(a), _t(b)).numpy(),
                                  out)


def test_led_matmul_torch_stacked_matches_jax():
    rng = _rng(8)
    x = _f32(rng, 3, 5, 32)
    a, b = _f32(rng, 3, 32, 6, scale=0.2), _f32(rng, 3, 6, 24, scale=0.4)
    ref = np.asarray(led_matmul_ref(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(b)))
    kern = np.asarray(jax_led_matmul(jnp.asarray(x), jnp.asarray(a),
                                     jnp.asarray(b)))
    for fn in (led_matmul_torch, led_matmul):
        out = fn(_t(x), _t(a), _t(b)).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_allclose(out, kern, **TOL)


def test_led_matmul_torch_rounds_once_in_bf16():
    """bf16 inputs: fp32 products, one rounding at the end (as the JAX
    oracle), not a rounding of the rank-r intermediate."""
    rng = _rng(9)
    x = _f32(rng, 4, 64).astype(ml_dtypes.bfloat16)
    a = _f32(rng, 64, 8, scale=0.1).astype(ml_dtypes.bfloat16)
    b = _f32(rng, 8, 16, scale=0.3).astype(ml_dtypes.bfloat16)
    out = led_matmul_torch(bridge.to_tensor(x), bridge.to_tensor(a),
                           bridge.to_tensor(b))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(led_matmul_ref(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(b))).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2)


def test_led_fuse_cuda_on_cpu_raises_and_auto_takes_plain_version():
    rng = _rng(10)
    a, b, x = _f32(rng, 16, 4), _f32(rng, 4, 8), _f32(rng, 2, 16)
    before = led_matmul.launches
    with pytest.raises(RuntimeError, match="fuse='cuda'"):
        LED(_t(a), _t(b), fuse="cuda")(_t(x))
    auto = LED(_t(a), _t(b), fuse="auto")(_t(x))
    plain = LED(_t(a), _t(b), fuse="torch")(_t(x))
    np.testing.assert_array_equal(auto.numpy(), plain.numpy())
    assert led_matmul.launches == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="unknown fuse"):
        LED(_t(a), _t(b), fuse="pallas")


# ---- the kernel builder: no nvcc or a failed build raises --------------------


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("led_matmul")


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'led_matmul.cu(1): error: broken' >&2\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="error: broken"):
        _build.load("led_matmul")
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_all_starts_one_nvcc_per_source_together(monkeypatch,
                                                       tmp_path):
    from repro_torch.kernels import _build

    log = tmp_path / "log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\nprev=''\nfor a in \"$@\"; do\n"
        "  [ \"$prev\" = -o ] && out=$a\n  prev=$a\ndone\n"
        f"echo start >> {log}\nsleep 0.5\necho end >> {log}\n"
        "touch \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_seconds", {})
    names = ("led_matmul", "paged_attention", "chunk_attention")
    paths = _build.build_all(names)
    assert set(paths) == set(names)
    assert all(p.exists() and p.parent == tmp_path / "build"
               for p in paths.values())
    # every process started before any finished
    assert log.read_text().split() == ["start"] * 3 + ["end"] * 3
    assert all(_build.build_seconds[n] > 0 for n in names)
    assert _build.build_all(names) == paths  # built: nothing runs again
    assert log.read_text().split() == ["start"] * 3 + ["end"] * 3
