"""The PyTorch port's kernel layer held against the JAX reference, on the CPU.

Both packages compute on the same operands: the reference's seeded
``make_args`` arrays cross to the port through ``registry.from_jax_args``.
The reference runs its Pallas kernels in interpret mode (as its own tests do
on the CPU) and its jnp oracles; the port's wrappers, given CPU tensors, run
the plain PyTorch versions.  Tolerances are the reference's own: max-abs
2e-5 in fp32 (tests/test_kernels_parity.py:23) and rtol = atol = 2e-2 in
bf16 (tests/test_kernels.py:13).  The CUDA kernels themselves run
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
from repro_torch.kernels import _build, ops, ref
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
    with pytest.raises(ValueError, match="k is on meta, the other operands on cpu"):
        ops.flash_attention(q, k.to("meta"), v.to("meta"))
    # all on meta: the dry run's route, the kernel's output shape and no launch
    before = ops.launch_counts()
    assert ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta")).shape == q.shape
    assert ops.launch_counts() == before
    o = ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention_bwd(q, k, v, o, o, lse=torch.zeros(q.shape[:2]))
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention_bwd(q, k, v, o, o, lse=torch.zeros(q.shape[:3], dtype=torch.float64))
    x, w = treg.get_kernel("moe_gmm").make_args(treg.get_kernel("moe_gmm").tiny_shape, "float32", 0, "cpu")
    with pytest.raises(ValueError, match="shape"):
        ops.moe_gmm(x, w[:, :64].contiguous())
    la, gx, h0 = treg.get_kernel("rglru_scan").make_args(treg.get_kernel("rglru_scan").tiny_shape, "float32", 0, "cpu")
    with pytest.raises(TypeError, match="dtype"):
        ops.rglru_scan(la.double(), gx, h0)
    with pytest.raises(ValueError, match="divide"):
        ops.rglru_scan(la, gx, h0, block_d=96)


def test_a_default_block_that_does_not_divide_falls_back_to_its_largest_divisor(monkeypatch):
    """A rank's share of the channels under tensor parallelism need not be a
    multiple of a kernel's default block (recurrentgemma-2b's 2560 RG-LRU
    channels on two ranks are 1280, against 512): the wrappers then take the
    largest divisor below the default, and keep a given block as given,
    which the divisibility check refuses."""
    monkeypatch.delenv("HYDRA_AUTOTUNE", raising=False)
    cpu = torch.device("cpu")
    assert ops._resolve("rglru_scan", {"B": 1, "L": 8, "dr": 1280}, torch.float32, cpu, {"block_d": 512},
                        {"block_d": None}, {"block_d": 1280}) == {"block_d": 320}
    # arctic-480b's expert products: C 80, D 7168 and F 4864 (= 2^8 x 19)
    assert ops._resolve("moe_gmm", {"E": 2, "C": 80, "D": 7168, "F": 4864}, torch.bfloat16, cpu,
                        {"block_c": 128, "block_f": 256, "block_d": 512}, {"block_c": None, "block_f": None, "block_d": None},
                        {"block_c": 80, "block_f": 4864, "block_d": 7168}) == {"block_c": 80, "block_f": 256, "block_d": 512}
    assert [ops.block_dividing(n, 512) for n in (1280, 4864, 96, 7)] == [320, 304, 96, 7]
    gen = np.random.default_rng(0)
    la = torch.from_numpy(np.log(gen.uniform(0.5, 0.99, (1, 8, 1280))).astype(np.float32))
    gx = torch.from_numpy(gen.normal(size=(1, 8, 1280)).astype(np.float32))
    y, h = ops.rglru_scan(la, gx)
    want_y, want_h = ref.rglru_ref(la, gx, torch.zeros(1, 1280))
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    with pytest.raises(ValueError, match="divide"):
        ops.rglru_scan(la, gx, block_d=512)


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


def test_build_rehashes_when_a_header_changes(monkeypatch, tmp_path):
    """An edit to a header that a source includes names a new library, so a
    stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    assert (csrc / "hopper.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before == {name: _build.library_path(name) for name in _build.SOURCES}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(after[name] != before[name] for name in _build.SOURCES)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-I/nonexistent/include"))
    assert all(_build.library_path(name) != after[name] for name in _build.SOURCES)


# (kernel, payload shape, dtype, route): bf16 at each model width and off the
# tile grid takes the tensor cores (``wgmma``), and so do fp32 attention at
# head widths 16 to 128 and fp32 GEMMs whose strides TMA can describe
# (``tf32x3``: three TF32 products a term; ``tf32x3_cluster`` at 256); a
# bf16 GEMM whose 200-byte row stride TMA cannot describe and an fp32 one
# whose F = 50 take warp-level ``mma``
_ROUTES = [
    ("flash_attention", {"B": 1, "H": 32, "KV": 8, "L": 4096, "hd": 128, "causal": True, "window": None}, "bfloat16", "wgmma"),
    ("flash_attention", {"B": 1, "H": 10, "KV": 1, "L": 4096, "hd": 256, "causal": True, "window": 2048}, "bfloat16", "wgmma"),
    ("flash_attention", {"B": 1, "H": 4, "KV": 1, "L": 320, "hd": 256, "causal": True, "window": 100}, "bfloat16", "wgmma"),
    ("moe_gmm", {"E": 8, "C": 1280, "D": 6144, "F": 32768}, "bfloat16", "wgmma"),
    ("moe_gmm", {"E": 3, "C": 80, "D": 96, "F": 200}, "bfloat16", "wgmma"),
    ("moe_gmm", {"E": 3, "C": 80, "D": 96, "F": 100}, "bfloat16", "mma"),
    *[(name, dict(getattr(treg.get_kernel(name), tier)), "float32", "tf32x3")
      for name in ("flash_attention", "moe_gmm") for tier in ("tiny_shape", "smoke_shape", "full_shape")],
    ("flash_attention", {"B": 1, "H": 32, "KV": 8, "L": 4096, "hd": 128, "causal": True, "window": None}, "float32", "tf32x3"),
    ("flash_attention", {"B": 2, "H": 4, "KV": 2, "L": 128, "hd": 16, "causal": True, "window": 16}, "float32", "tf32x3"),
    ("flash_attention", {"B": 1, "H": 10, "KV": 1, "L": 4096, "hd": 256, "causal": True, "window": 2048}, "float32", "tf32x3_cluster"),
    ("flash_attention", {"B": 2, "H": 4, "KV": 2, "L": 128, "hd": 16, "causal": True, "window": 16}, "bfloat16", "tf32"),
    ("moe_gmm", {"E": 8, "C": 1280, "D": 6144, "F": 32768}, "float32", "tf32x3"),
    ("moe_gmm", {"E": 3, "C": 80, "D": 96, "F": 100}, "float32", "tf32x3"),
    ("moe_gmm", {"E": 3, "C": 80, "D": 96, "F": 50}, "float32", "mma"),
    ("moe_gmm", {"E": 3, "C": 80, "D": 50, "F": 96}, "float32", "mma"),
]


@pytest.mark.parametrize("name,shape,dtype,want", _ROUTES, ids=lambda v: v if isinstance(v, str) else None)
def test_route_rule(name, shape, dtype, want):
    module = {"flash_attention": tfa, "moe_gmm": tgmm}[name]
    assert module.route(getattr(torch, dtype), shape) == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_route_refuses_a_head_width_the_kernels_lack(dtype):
    with pytest.raises(ValueError, match="head width"):
        tfa.route(getattr(torch, dtype), {"hd": 96})


def test_route_counts_read_and_reset():
    counts = ops.route_launch_counts()
    routes = {"flash_attention": ("wgmma", "tf32x3", "tf32", "tf32x3_cluster"), "moe_gmm": ("mma", "wgmma", "tf32x3")}
    assert counts == {name: {r: counts[name][r] for r in by} for name, by in routes.items()}
    tgmm.ROUTE_LAUNCHES["tf32x3"].bump()
    assert ops.route_launch_counts()["moe_gmm"]["tf32x3"] == counts["moe_gmm"]["tf32x3"] + 1
    tfa.ROUTE_LAUNCHES["wgmma"].bump()
    assert ops.route_launch_counts()["flash_attention"]["wgmma"] == counts["flash_attention"]["wgmma"] + 1
    tfa.ROUTE_LAUNCHES["tf32x3"].bump()
    assert ops.route_launch_counts()["flash_attention"]["tf32x3"] == counts["flash_attention"]["tf32x3"] + 1
    bwd = ops.backward_route_launch_counts()
    bwd_routes = {"flash_attention_bwd": routes["flash_attention"], "moe_gmm_bwd": routes["moe_gmm"]}
    assert bwd == {name: {r: bwd[name][r] for r in by} for name, by in bwd_routes.items()}
    for r in routes["flash_attention"]:
        tfa.BWD_ROUTE_LAUNCHES[r].bump()
    tgmm.BWD_ROUTE_LAUNCHES["wgmma"].bump()
    tgmm.BWD_LAUNCHES.bump()
    assert ops.backward_route_launch_counts()["flash_attention_bwd"] == {r: n + 1 for r, n in bwd["flash_attention_bwd"].items()}
    assert ops.backward_route_launch_counts()["moe_gmm_bwd"]["wgmma"] == bwd["moe_gmm_bwd"]["wgmma"] + 1
    ops.reset_launch_counts()
    assert ops.route_launch_counts() == {name: {r: 0 for r in by} for name, by in routes.items()}
    assert ops.backward_route_launch_counts() == {name: {r: 0 for r in by} for name, by in bwd_routes.items()}
    assert set(ops.launch_counts().values()) == {0} and set(ops.backward_launch_counts().values()) == {0}


# (dtype, head width, backward route): every width on the tensor cores, on
# the forward's route: bf16 on wgmma from hd 32 and on one TF32 product at
# 16 (tf32); fp32 on tf32x3 up to 128 and on two-block clusters at 256
_BWD_ROUTES = [
    (dt, hd, ("wgmma" if hd >= 32 else "tf32") if dt == "bfloat16" else ("tf32x3" if hd <= 128 else "tf32x3_cluster"))
    for dt in ("bfloat16", "float32") for hd in (16, 32, 64, 128, 256)
]


@pytest.mark.parametrize("dtype,hd,want", _BWD_ROUTES)
def test_backward_route_rule(dtype, hd, want):
    assert tfa.bwd_route(getattr(torch, dtype), hd) == want
    # the backward reads the LSE its forward writes, on the same route
    assert tfa.route(getattr(torch, dtype), {"hd": hd}) == want
    assert want in tfa.BWD_ENTRIES and "simt" not in tfa.ROUTES


@pytest.mark.parametrize("dtype,hd", [("bfloat16", 96), ("float32", 96), ("bfloat16", 512), ("float32", 8), ("float16", 64)])
def test_backward_route_refuses_what_the_kernels_lack(dtype, hd):
    with pytest.raises(ValueError, match="head width"):
        tfa.bwd_route(getattr(torch, dtype), hd)


# (B, KV, H, Lk, blocks a k tile, parts on 132 SMs), wgmma (one dK/dV block
# a k tile): recurrentgemma-2b's 64 k tiles split in 2; llama3-8b's 512
# blocks fill the card alone; a short MQA sequence splits its 10 heads
# apart.  tf32x3 (a dK and a dV block a k tile): the broker's fp32 Lq96 Lk200
# case and the reduced hd 16 case go from 16 blocks to 32; llama3-8b's
# card-vs-CPU gradient check (L 256) from 64 to 128; recurrentgemma-2b's
# 128 blocks fill the card alone
_KV_PARTS = [
    (1, 1, 10, 4096, 1, 2), (2, 8, 32, 2048, 1, 1), (1, 8, 32, 4096, 1, 1), (1, 1, 10, 128, 1, 10),
    (1, 2, 8, 1024, 1, 4), (2, 4, 8, 2048, 1, 1),
    (1, 2, 4, 200, 2, 2), (2, 2, 4, 128, 2, 2), (1, 8, 32, 256, 2, 2), (1, 1, 10, 4096, 2, 1),
]


@pytest.mark.parametrize("b,n_kv,h,lk,roles,want", _KV_PARTS)
def test_kv_parts_rule_fills_the_card(b, n_kv, h, lk, roles, want):
    got = tfa.kv_parts(b, n_kv, h, lk, 132, roles)
    assert got == want and (h // n_kv) % got == 0
    blocks = roles * -(-lk // tfa.KV_BLOCK_ROWS) * b * n_kv * got
    assert blocks > 16 or got == h // n_kv  # no small grid left unsplit while heads remain to split


def test_wgmma_backward_pads_its_row_statistics():
    assert [tfa.stats_rows(n) for n in (1, 96, 128, 129, 333, 4096)] == [128, 128, 128, 256, 384, 4096]


def test_ptxas_report_is_parsed_per_kernel():
    log = """ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__08759a66_28_flash_attention_bwd_wgmma_cu_b53c6ca017attn_bwd_kv_wgmmaILi256EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN61_GLOBAL__N__08759a66_28_flash_attention_bwd_wgmma_cu_b53c6ca017attn_bwd_kv_wgmmaILi256EEEv14CUtensorMap_st
    112 bytes stack frame, 112 bytes spill stores, 172 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__08759a66_28_flash_attention_bwd_wgmma_cu_b53c6ca015attn_bwd_kv_sumEPK6float4' for 'sm_90a'
ptxas info    : Function properties for _ZN61_GLOBAL__N__08759a66_28_flash_attention_bwd_wgmma_cu_b53c6ca015attn_bwd_kv_sumEPK6float4
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__0a1b2c3d_21_selective_scan_bwd_cu_9f8e7d6c17selective_bwd_sumEPKfS1_PfS2_S2_iiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN61_GLOBAL__N__0a1b2c3d_21_selective_scan_bwd_cu_9f8e7d6c17selective_bwd_sumEPKfS1_PfS2_S2_iiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 1 barriers, 1024 bytes smem, 424 bytes cmem[0]"""
    assert _build.ptxas_usage(log) == [
        {"kernel": "attn_bwd_kv_wgmma<256>", "stack": 112, "spill_stores": 112, "spill_loads": 172, "registers": 168},
        {"kernel": "attn_bwd_kv_sum", "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 46},
        {"kernel": "selective_bwd_sum", "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 24,
         "static_smem": 1024},
    ]
    assert _build.kernel_label("_Z3fooPf") == "_Z3fooPf"
    # a kernel in a namespace nested in the anonymous one: the last name
    nested = "_ZN55_GLOBAL__N__7a3cd1f2_18_flash_attention_cu_5e2b8c416tf32x316flash_fwd_tf32x3ILi128EEEvPKfS3_S3_Pf"
    assert _build.kernel_label(nested) == "flash_fwd_tf32x3<128>"
    # csrc/moe_gmm.cu's kernels sit in nested namespaces too (tc, tf32x3),
    # and a kernel templated on a type keeps its bare name
    gmm = "_ZN49_GLOBAL__N__0a1b2c3d_10_moe_gmm_cu_9f8e7d6c2tc9gmm_wgmmaE14CUtensorMap_stS1_Pf"
    assert _build.kernel_label(gmm) == "gmm_wgmma"
    typed = "_ZN55_GLOBAL__N__7a3cd1f2_18_flash_attention_bwd_cu_5e2b8c4117attn_bwd_rowstatsIfEEvPKT_S3_PKfP6float2iiii"
    assert _build.kernel_label(typed) == "attn_bwd_rowstats"
