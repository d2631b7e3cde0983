"""The PyTorch port's kernel layer held against the JAX reference, on the CPU.

Both packages compute on the same operands: the reference's seeded
``make_args`` arrays cross to the port through ``registry.from_jax_args``.
The reference runs its Pallas kernels in interpret mode (as its own tests do
on the CPU) and its jnp oracles; the port's wrappers, given CPU tensors, run
the plain PyTorch versions.  Tolerances are the reference's own: max-abs
2e-5 in fp32 (tests/test_kernels_parity.py:23) and rtol = atol = 2e-2 in
bf16 (tests/test_kernels.py:13).  The CUDA and Triton kernels themselves run
only on a GPU: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them
against these same plain versions there.
"""
from __future__ import annotations

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import registry as jreg
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import registry as treg
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import selective_scan as tss

# the shapes here are small: one intra-op thread keeps the CPU free for the
# other test workers, whose timing-sensitive broker tests share the machine
torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _f32(out) -> list:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [
        o.float().numpy() if isinstance(o, torch.Tensor) else np.asarray(o, np.float32)
        for o in outs
    ]


def _assert_close(got, want, dtype: str) -> None:
    for g, w in zip(_f32(got), _f32(want)):
        assert g.shape == w.shape
        if dtype == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=BF16_TOL, atol=BF16_TOL)
        else:
            assert float(np.max(np.abs(g - w))) <= F32_TOL


def _run_both(name: str, shape: dict, dtype: str, config: dict, seed: int = 0):
    """(reference Pallas kernel, reference oracle, port) on one operand set."""
    jdef, tdef = jreg.get_kernel(name), treg.get_kernel(name)
    jargs = jdef.make_args(shape, dtype, seed)
    targs = treg.from_jax_args(name, [np.asarray(a) for a in jargs], "cpu")
    return (
        jdef.call(shape, jargs, config, True),
        jdef.ref(shape, jargs),
        tdef.call(shape, targs, config),
    )


@pytest.mark.parametrize("name", sorted(treg.KERNELS))
@pytest.mark.parametrize("tier", ["tiny", "smoke"])
def test_port_matches_reference_at_registry_tiers(name, tier):
    shape = dict(getattr(treg.get_kernel(name), f"{tier}_shape"))
    config = treg.get_kernel(name).defaults(shape)
    kernel, oracle, port = _run_both(name, shape, "float32", config)
    _assert_close(port, kernel, "float32")
    _assert_close(port, oracle, "float32")


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm"])
def test_port_matches_reference_in_bf16(name):
    shape = dict(treg.get_kernel(name).tiny_shape)
    kernel, oracle, port = _run_both(name, shape, "bfloat16", treg.get_kernel(name).defaults(shape))
    assert port.dtype == torch.bfloat16
    _assert_close(port, kernel, "bfloat16")
    _assert_close(port, oracle, "bfloat16")


_VARIANTS = {  # tests/test_kernels_parity.py:65-72, plus the non-power-of-two length
    # and the head widths of llama3-8b (128) and recurrentgemma-2b (256)
    "gqa_hd128": {"H": 4, "KV": 2, "L": 128, "hd": 128, "causal": True, "window": None},
    "mqa_windowed_hd256": {"H": 2, "KV": 1, "L": 128, "hd": 256, "causal": True, "window": 64},
    "mha_causal": {"H": 4, "KV": 4, "L": 128, "causal": True, "window": None},
    "mha_full": {"H": 4, "KV": 4, "L": 128, "causal": False, "window": None},
    "gqa_causal": {"H": 4, "KV": 2, "L": 128, "causal": True, "window": None},
    "mqa_causal": {"H": 4, "KV": 1, "L": 128, "causal": True, "window": None},
    "windowed": {"H": 4, "KV": 4, "L": 128, "causal": True, "window": 32},
    "gqa_windowed": {"H": 4, "KV": 2, "L": 128, "causal": True, "window": 64},
    "non_pow2": {"H": 2, "KV": 2, "L": 192, "causal": True, "window": None},
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_port_attention_variants(variant):
    shape = {"B": 1, "hd": 32, **_VARIANTS[variant]}
    kernel, oracle, port = _run_both("flash_attention", shape, "float32", {"block_q": 64, "block_k": 32})
    _assert_close(port, kernel, "float32")
    _assert_close(port, oracle, "float32")


_SWEEPS = [  # the reference's own sweep cases (tests/test_kernels.py:17-109)
    *[("flash_attention", dict(zip("B H KV L hd".split(), s)), dt, {"block_q": s[5], "block_k": s[5]})
      for s in [(1, 4, 4, 128, 64, 64), (2, 8, 2, 256, 64, 128), (1, 4, 1, 128, 32, 32), (1, 2, 2, 192, 64, 64)]
      for dt in ("float32", "bfloat16")],
    *[("selective_scan", dict(zip("B chunk di N".split(), s)), "float32", {"block_d": s[4]})
      for s in [(1, 16, 64, 4, 32), (2, 32, 128, 16, 64), (2, 64, 256, 16, 256)]],
    *[("rglru_scan", dict(zip("B L dr".split(), s)), "float32", {"block_d": s[3]})
      for s in [(1, 32, 128, 64), (2, 64, 256, 128), (2, 128, 512, 512)]],
    *[("moe_gmm", dict(zip("E C D F".split(), s)), dt, {"block_c": 32, "block_f": 64, "block_d": 64})
      for s in [(2, 32, 64, 128), (4, 64, 128, 256), (8, 128, 256, 128)]
      for dt in ("float32", "bfloat16")],
]


def _sweep_operands(name: str, shape: dict, dtype: str) -> list:
    """numpy operands drawn as the reference's sweep tests draw them (h0
    nonzero for the scans, so the chained state is exercised)."""
    rng = np.random.default_rng(42)
    f32 = np.float32
    if name == "flash_attention":
        B, H, KV, L, hd = (shape[k] for k in ("B", "H", "KV", "L", "hd"))
        arrs = [rng.normal(size=(B, n, L, hd)) for n in (H, KV, KV)]
        return [np.asarray(jnp.asarray(a, dtype)) for a in arrs]
    if name == "selective_scan":
        B, ck, di, N = (shape[k] for k in ("B", "chunk", "di", "N"))
        return [
            rng.normal(size=(B, ck, di)).astype(f32), rng.uniform(0.001, 0.1, (B, ck, di)).astype(f32),
            rng.normal(size=(B, ck, N)).astype(f32), rng.normal(size=(B, ck, N)).astype(f32),
            -rng.uniform(0.5, 2.0, (di, N)).astype(f32), rng.normal(size=(B, di, N)).astype(f32),
        ]
    if name == "rglru_scan":
        B, L, dr = (shape[k] for k in ("B", "L", "dr"))
        return [-rng.uniform(0.01, 1.0, (B, L, dr)).astype(f32), rng.normal(size=(B, L, dr)).astype(f32),
                rng.normal(size=(B, dr)).astype(f32)]
    E, C, D, F = (shape[k] for k in ("E", "C", "D", "F"))
    return [np.asarray(jnp.asarray(rng.normal(size=(E, C, D)), dtype)),
            np.asarray(jnp.asarray(rng.normal(size=(E, D, F)) * 0.1, dtype))]


@pytest.mark.parametrize("name,shape,dtype,config", _SWEEPS, ids=lambda v: v if isinstance(v, str) else None)
def test_port_matches_reference_oracle_on_its_sweeps(name, shape, dtype, config):
    if name == "flash_attention":
        shape = {**shape, "causal": True, "window": None}
    arrays = _sweep_operands(name, shape, dtype)
    want = jreg.get_kernel(name).ref(shape, tuple(jnp.asarray(a) for a in arrays))
    got = treg.get_kernel(name).call(shape, treg.from_jax_args(name, arrays), config)
    _assert_close(got, want, dtype)


def test_port_scan_chunks_chain_through_h0():
    """Two port chunks chained via h0 == one double-length reference chunk
    (tests/test_kernels.py:73)."""
    rng = np.random.default_rng(42)
    B, ck, di, N = 1, 16, 64, 8
    x = rng.normal(size=(B, 2 * ck, di)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, 2 * ck, di)).astype(np.float32)
    bm = rng.normal(size=(B, 2 * ck, N)).astype(np.float32)
    cm = rng.normal(size=(B, 2 * ck, N)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (di, N)).astype(np.float32)
    h0 = np.zeros((B, di, N), np.float32)
    y_full, h_full = jops.selective_scan_chunk(*map(jnp.asarray, (x, dt, bm, cm, a, h0)), block_d=32)

    def half(s):
        return [np.ascontiguousarray(t[:, s]) for t in (x, dt, bm, cm)]

    first = treg.from_jax_args("selective_scan", [*half(slice(0, ck)), a, h0])
    _, h1 = ops.selective_scan_chunk(*first, block_d=32)
    xs, dts, bs, cs = treg.from_jax_args("selective_scan", [*half(slice(ck, 2 * ck)), a, h0])[:4]
    y2, h2 = ops.selective_scan_chunk(xs, dts, bs, cs, torch.from_numpy(a), h1, block_d=32)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_full[:, ck:]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_full), rtol=1e-5, atol=1e-5)


def test_port_rglru_without_h0_starts_from_zeros():
    rng = np.random.default_rng(3)
    la = -rng.uniform(0.01, 1.0, (2, 32, 64)).astype(np.float32)
    gx = rng.normal(size=(2, 32, 64)).astype(np.float32)
    want = jops.rglru_scan(jnp.asarray(la), jnp.asarray(gx), None, block_d=64)
    got = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(gx), None, block_d=64)
    _assert_close(got, want, "float32")


# ---------------------------------------------------------------------------
# the registry: same names, shapes, signatures; seeded operands; least work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jreg.KERNELS))
def test_registry_keeps_reference_names_shapes_and_signatures(name):
    jdef, tdef = jreg.get_kernel(name), treg.get_kernel(name)
    assert tdef.params == jdef.params
    for tier in ("tiny_shape", "smoke_shape", "full_shape"):
        shape = getattr(jdef, tier)
        assert getattr(tdef, tier) == shape
        for dtype in ("float32", "bfloat16"):
            assert treg.shape_sig(shape, dtype) == jreg.shape_sig(shape, dtype)
        assert tdef.defaults(shape) == jdef.defaults(shape)
        assert treg.config_sig(tdef.defaults(shape)) == jreg.config_sig(jdef.defaults(shape))
    assert len(tdef.operands) == len(jdef.make_args(jdef.tiny_shape, "float32", 0))


def test_make_args_is_seed_deterministic():
    for name, kdef in treg.KERNELS.items():
        shape = dict(kdef.tiny_shape)
        a = kdef.make_args(shape, "float32", 3, "cpu")
        b = kdef.make_args(shape, "float32", 3, "cpu")
        c = kdef.make_args(shape, "float32", 4, "cpu")
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert any(not torch.equal(x, y) for x, y in zip(a, c)), f"{name}: seed does not reach the operands"


def test_from_jax_args_is_exact_for_bf16():
    jdef = jreg.get_kernel("flash_attention")
    arrays = [np.asarray(a) for a in jdef.make_args(jdef.tiny_shape, "bfloat16", 5)]
    assert arrays[0].dtype.name == "bfloat16"
    tensors = treg.from_jax_args("flash_attention", arrays)
    for arr, t in zip(arrays, tensors):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
    with pytest.raises(ValueError):
        treg.from_jax_args("flash_attention", arrays[:2])


def test_cost_counts_the_least_work_of_the_model_widths():
    """The counts the card's roofline bounds are built from (each input read
    once, each output written once; live attention pairs only)."""
    llama = {"B": 1, "H": 32, "KV": 8, "L": 4096, "hd": 128, "causal": True, "window": None}
    c = treg.get_kernel("flash_attention").cost(llama, "bfloat16")
    assert c.flops == 4 * 32 * (4096 * 4097 // 2) * 128
    assert c.hbm_bytes == 2 * 4096 * 128 * (2 * 32 + 2 * 8)
    rg = {"B": 1, "H": 10, "KV": 1, "L": 4096, "hd": 256, "causal": True, "window": 2048}
    live = 2048 * 2049 // 2 + (4096 - 2048) * 2048
    assert treg.get_kernel("flash_attention").cost(rg, "bfloat16").flops == 4 * 10 * live * 256
    gmm = treg.get_kernel("moe_gmm").cost({"E": 8, "C": 1280, "D": 6144, "F": 32768}, "bfloat16")
    assert gmm.flops == 2 * 8 * 1280 * 6144 * 32768
    assert gmm.hbm_bytes == 2 * 8 * (1280 * 6144 + 6144 * 32768 + 1280 * 32768)
    rgl = treg.get_kernel("rglru_scan").cost({"B": 2, "L": 4096, "dr": 2560}, "float32")
    assert (rgl.flops, rgl.hbm_bytes) == (3 * 2 * 4096 * 2560, 4 * (3 * 2 * 4096 * 2560 + 2 * 2 * 2560))
    ss = treg.get_kernel("selective_scan").cost({"B": 1, "chunk": 256, "di": 8192, "N": 16}, "float32")
    assert ss.flops == 6 * 256 * 8192 * 16
    assert 26e6 < ss.hbm_bytes < 28e6


# ---------------------------------------------------------------------------
# routing, checks and launch counts
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = ops.launch_counts()
    for name, kdef in treg.KERNELS.items():
        shape = dict(kdef.tiny_shape)
        args = kdef.make_args(shape, "float32", 0, "cpu")
        got = kdef.call(shape, args, kdef.defaults(shape))
        _assert_close(got, kdef.ref(shape, args), "float32")
    assert ops.launch_counts() == before


@pytest.mark.parametrize(
    "launch,name",
    [
        (lambda a: tfa.flash_attention(*a), "flash_attention"),
        (lambda a: tss.selective_scan_chunk(*a), "selective_scan"),
        (lambda a: trg.rglru_scan(*a), "rglru_scan"),
        (lambda a: tgmm.moe_gmm(*a), "moe_gmm"),
    ],
)
def test_kernel_launchers_refuse_cpu_tensors(launch, name):
    kdef = treg.get_kernel(name)
    args = kdef.make_args(kdef.tiny_shape, "float32", 0, "cpu")
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        launch(args)
    assert ops.launch_counts() == before


def test_wrappers_check_operands():
    q, k, v = treg.get_kernel("flash_attention").make_args(treg.get_kernel("flash_attention").tiny_shape, "float32", 0, "cpu")
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention(q, k, v[:, :, :64].contiguous())
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention(q, k, v, block_q=48)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    x, w = treg.get_kernel("moe_gmm").make_args(treg.get_kernel("moe_gmm").tiny_shape, "float32", 0, "cpu")
    with pytest.raises(ValueError, match="shape"):
        ops.moe_gmm(x, w[:, :64].contiguous())
    la, gx, h0 = treg.get_kernel("rglru_scan").make_args(treg.get_kernel("rglru_scan").tiny_shape, "float32", 0, "cpu")
    with pytest.raises(TypeError, match="dtype"):
        ops.rglru_scan(la.double(), gx, h0)
    with pytest.raises(ValueError, match="divide"):
        ops.rglru_scan(la, gx, h0, block_d=96)


def test_launch_counter_is_thread_safe():
    counter = _build.LaunchCounter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.bump() for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.value == 16 * 2000
    counter.reset()
    assert counter.value == 0


def test_build_names_libraries_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert path.name.endswith(".so")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
