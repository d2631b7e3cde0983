"""The port's autotuner (repro_torch/kernels/autotune.py) against the reference.

The sweep spaces and the tiling arithmetic (FLOPs, re-fetched tile traffic,
grid cells) must equal the reference's exactly, config by config.  The two
cost models differ on purpose -- the port prices each config's shared memory
per block against the H100's 227 KB and scores with the card's peaks -- so
the pruned frontier and the model-timer winner are held equal only with the
budgets and constants set to the reference's.  The behavioural tests are the
reference's (tests/test_autotune.py), run on the port; the wall timer's
dedupe by launch key, and the launch keys (each kernel's route and the
variant its launcher's ``tile`` maps a config to), are the port's own.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels import registry as jreg
from repro_torch.core import Hydra, ProviderSpec, Task
from repro_torch.core.events import EventBus
from repro_torch.core.staging import SHARED_SITE, DatasetRegistry
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops
from repro_torch.kernels import registry as kreg
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels.autotune import (
    Autotuner,
    autotune_enabled,
    predict_best,
    set_autotuner,
    tuned_config,
    unset_autotuner,
)

from conftest import wait_until

torch.set_num_threads(1)

TIERS = ("tiny", "smoke", "full")
CASES = [(name, tier) for name in sorted(kreg.KERNELS) for tier in TIERS]
# the reference's demo problem: rglru traffic is config-independent, so the
# frontier collapses to the largest admissible block
DEMO = ("rglru_scan", {"B": 1, "L": 64, "dr": 1024})
EVERYTHING = 1 << 40  # a budget every config fits


def _shape(name, tier):
    return dict(getattr(kreg.get_kernel(name), f"{tier}_shape"))


def _model_tuner(**kw) -> Autotuner:
    kw.setdefault("device", "cpu")
    return Autotuner(timer="model", **kw)


# ---------------------------------------------------------------------------
# spaces and tiling arithmetic: exact parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,tier", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_space_and_tiling_arithmetic_equal_the_reference(name, tier, dtype):
    shape = _shape(name, tier)
    kdef, jdef = kreg.get_kernel(name), jreg.get_kernel(name)
    space = kdef.space(shape)
    assert space == jdef.space(shape)
    for cfg in space:
        port, ref = kdef.tile_cost(shape, cfg, dtype), jdef.cost(shape, cfg, dtype)
        assert (port.flops, port.hbm_bytes, port.grid_cells) == (ref.flops, ref.hbm_bytes, ref.grid_cells)


@pytest.mark.parametrize("name,tier", CASES)
def test_survivors_equal_the_reference_when_every_config_fits(name, tier):
    shape = _shape(name, tier)
    port, n_port = _model_tuner(smem_budget=EVERYTHING).prune(name, shape)
    ref, n_ref = jat.Autotuner(timer="model", vmem_budget=EVERYTHING).prune(name, shape)
    assert (port, n_port) == (ref, n_ref)


@pytest.fixture
def reference_constants(monkeypatch):
    """The reference's roofline constants in the port's model."""
    from repro.roofline.model import HBM_BW, PEAK_FLOPS

    monkeypatch.setattr(tat, "HBM_BYTES_PER_S", HBM_BW)
    monkeypatch.setattr(tat, "PEAK_OPS_PER_S", {"float32": PEAK_FLOPS, "bfloat16": PEAK_FLOPS})
    monkeypatch.setattr(tat, "MODEL_CELL_OVERHEAD_S", jat.MODEL_CELL_OVERHEAD_S)
    assert (HBM_BW, PEAK_FLOPS, jat.MODEL_CELL_OVERHEAD_S) == (819e9, 197e12, 1e-6)


@pytest.mark.parametrize("name,tier", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_winner_equals_the_reference_under_its_constants(reference_constants, name, tier, dtype):
    """Each config's shared-memory footprint is the tile bytes the
    reference prices as VMEM, so under the reference's budget and roofline
    constants the two tuners must pick the same config."""
    shape = _shape(name, tier)
    port = _model_tuner(smem_budget=jat.VMEM_BUDGET_BYTES).tune(name, shape, dtype)
    ref = jat.Autotuner(timer="model").tune(name, shape, dtype)
    assert port.config == ref.config
    assert (port.exhaustive, port.swept, port.pruned) == (ref.exhaustive, ref.swept, ref.pruned)


def test_hopper_budget_prunes_what_one_block_cannot_hold():
    """moe_gmm's full tier has fp32 tile sets past 227 KB: the Hopper budget
    drops them, the reference's 16 MiB VMEM keeps them."""
    name, shape = "moe_gmm", _shape("moe_gmm", "full")
    kdef = kreg.get_kernel(name)
    over = [c for c in kdef.space(shape) if kdef.tile_cost(shape, c, "float32").smem_bytes > tat.SMEM_BUDGET_BYTES]
    assert over
    survivors, _ = _model_tuner().prune(name, shape)
    assert survivors and not any(c in over for c in survivors)
    assert all(kdef.tile_cost(shape, c, "float32").smem_bytes <= 232448 for c in survivors)


def test_model_time_uses_the_cards_peak_for_the_dtype():
    cost = kreg.TileCost(flops=67e12, hbm_bytes=0.0, grid_cells=0, smem_bytes=0.0)
    assert Autotuner.model_time_s(cost, "float32") == pytest.approx(1.0)
    assert Autotuner.model_time_s(cost, "bfloat16") == pytest.approx(67 / 989)
    traffic = kreg.TileCost(flops=0.0, hbm_bytes=3.35e12, grid_cells=2, smem_bytes=0.0)
    assert Autotuner.model_time_s(traffic) == pytest.approx(1.0 + 2e-6)


def test_least_work_cost_is_unchanged_by_the_tiling_terms():
    """chip_smoke.py's bound reads ``cost``: the least work, not the tiles."""
    name, shape = "moe_gmm", _shape("moe_gmm", "full")
    kdef = kreg.get_kernel(name)
    least = kdef.cost(shape, "float32")
    E, C, D, F = (shape[k] for k in "ECDF")
    assert (least.flops, least.hbm_bytes) == (2.0 * E * C * D * F, 4.0 * E * (C * D + D * F + C * F))
    assert all(kdef.tile_cost(shape, c, "float32").hbm_bytes >= least.hbm_bytes for c in kdef.space(shape))


# ---------------------------------------------------------------------------
# the reference's behavioural contract (tests/test_autotune.py:84-190)
# ---------------------------------------------------------------------------


def test_prune_cuts_demo_sweep_and_tune_picks_the_widest_block_that_fits():
    """The reference picks the full width, 1024 channels of 776 bytes of
    tiles each: 776 KB fit a 16 MiB VMEM but not a block's 227 KB of
    shared memory, which holds 256 of those channels at most."""
    name, shape = DEMO
    result = _model_tuner().tune(name, shape)
    assert result.sweep_cut >= 2.0
    assert result.exhaustive == result.swept + result.pruned
    assert result.config == {"block_d": 256}
    assert kreg.config_sig(result.config) in result.timings
    assert _model_tuner(smem_budget=EVERYTHING).tune(name, shape).config == {"block_d": 1024}


def test_degenerate_budget_falls_back_to_defaults_and_a_tight_one_shrinks_the_winner():
    name, shape = DEMO
    kdef = kreg.get_kernel(name)
    tiny = _model_tuner(smem_budget=1)
    assert tiny.prune(name, shape) == ([kdef.defaults(shape)], len(kdef.space(shape)))
    assert tiny.tune(name, shape).config == kdef.defaults(shape)
    smallest = kdef.tile_cost(shape, {"block_d": 32}, "float32").smem_bytes
    assert _model_tuner(smem_budget=int(smallest)).tune(name, shape).config == {"block_d": 32}


def test_cache_hit_skips_retiming_and_emits_no_second_tune_event():
    name, shape = DEMO
    bus = EventBus(strict=False)
    tuner = _model_tuner(events=bus)
    first = tuner.tune(name, shape)
    second = tuner.tune(name, shape)
    assert not first.cached and second.cached
    assert second.config == first.config
    tune_events = [e for e in bus.events() if e.name == "kernel.tune"]
    assert len(tune_events) == 1
    assert tuner.stats() == {"tunes": 1, "swept_configs": first.swept}
    assert tune_events[0].attrs["swept"] == first.swept
    tuner.tune(name, {"B": 1, "L": 64, "dr": 128})
    assert len([e for e in bus.events() if e.name == "kernel.tune"]) == 2


def test_same_seed_runs_produce_byte_identical_payloads():
    name, shape = DEMO
    results, payloads = [], []
    for _ in range(2):
        tuner = _model_tuner(seed=7)
        r = tuner.tune(name, shape)
        results.append(r)
        payloads.append(tuner.payload(r.key))
    assert results[0].config == results[1].config
    assert isinstance(payloads[0], bytes) and payloads[0] == payloads[1]
    assert b"timings" not in payloads[0]
    assert b'"seed":7' in payloads[0] and b'"version":1' in payloads[0]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_winner_registers_as_pinned_shared_dataset_keyed_by_device_type(device):
    """Keys name the device type; a "cuda" tuner under the model timer
    touches no device, so this runs here too."""
    name, shape = DEMO
    registry = DatasetRegistry()
    result = Autotuner(timer="model", registry=registry, device=device).tune(name, shape)
    assert result.key == f"tune:{name}:{device}:{kreg.shape_sig(shape, 'float32')}"
    assert result.device == device
    assert registry.known(result.key) and registry.get(result.key).pinned
    assert SHARED_SITE in registry.locate(result.key)


def test_the_default_tuner_is_for_the_card():
    assert Autotuner(timer="model").device == torch.device("cuda")
    assert tat.device_kind() == "cuda" and tat.device_kind("cpu") == "cpu"


@pytest.fixture
def global_tuner():
    tuner = _model_tuner()
    set_autotuner(tuner)
    yield tuner
    unset_autotuner(tuner)


def test_tuned_config_is_env_gated_and_per_device_type(monkeypatch, global_tuner):
    name, shape = DEMO
    global_tuner.tune(name, shape)
    monkeypatch.delenv("HYDRA_AUTOTUNE", raising=False)
    assert not autotune_enabled()
    assert tuned_config(name, shape) is None
    monkeypatch.setenv("HYDRA_AUTOTUNE", "0")
    assert tuned_config(name, shape) is None
    monkeypatch.setenv("HYDRA_AUTOTUNE", "1")
    assert tuned_config(name, shape) == {"block_d": 256}
    assert tuned_config(name, shape, device="cpu") == {"block_d": 256}
    assert tuned_config(name, shape, device="cuda") is None  # tuned for the CPU only
    assert tuned_config(name, {"B": 2, "L": 64, "dr": 256}) is None


def test_ops_resolution_order_explicit_beats_tuned_beats_default(monkeypatch, global_tuner):
    name, shape = DEMO
    global_tuner.tune(name, shape)
    cpu = torch.device("cpu")
    defaults = {"block_d": 512}
    monkeypatch.setenv("HYDRA_AUTOTUNE", "1")
    assert ops._resolve(name, shape, torch.float32, cpu, defaults, {"block_d": 64}) == {"block_d": 64}
    assert ops._resolve(name, shape, torch.float32, cpu, defaults, {"block_d": None}) == {"block_d": 256}
    monkeypatch.delenv("HYDRA_AUTOTUNE")
    assert ops._resolve(name, shape, torch.float32, cpu, defaults, {"block_d": None}) == {"block_d": 512}
    # the reference resolves the same way on the same cache contents
    jtuner = jat.Autotuner(timer="model")
    jat.set_autotuner(jtuner)
    try:
        jtuner.tune(name, shape)
        monkeypatch.setenv("HYDRA_AUTOTUNE", "1")
        from repro.kernels import ops as jops

        assert jops._resolve(name, shape, jnp.float32, defaults, {"block_d": None}) == {"block_d": 1024}
    finally:
        jat.unset_autotuner(jtuner)


def test_a_tuned_config_the_shape_rejects_fails_the_wrapper(monkeypatch, global_tuner):
    """The resolved config goes through the divisibility check: a tuned
    block that divides the tuned shape passes, an explicit one that does
    not divide it raises, as in the reference."""
    name, shape = DEMO
    global_tuner.tune(name, shape)
    monkeypatch.setenv("HYDRA_AUTOTUNE", "1")
    args = kreg.get_kernel(name).make_args(shape, "float32", 0, "cpu")
    ops.rglru_scan(*args)
    with pytest.raises(ValueError, match="divide"):
        ops.rglru_scan(*args, block_d=768)


def test_unset_autotuner_only_clears_its_own_installation(monkeypatch):
    a, b = _model_tuner(), _model_tuner()
    set_autotuner(a)
    unset_autotuner(b)
    name, shape = DEMO
    a.tune(name, shape)
    monkeypatch.setenv("HYDRA_AUTOTUNE", "1")
    try:
        assert tuned_config(name, shape) is not None
    finally:
        unset_autotuner(a)
    assert tuned_config(name, shape) is None


def test_predict_best_is_a_config_of_the_space():
    for name, kdef in kreg.KERNELS.items():
        row = predict_best(name, dict(kdef.smoke_shape))
        assert row["config"] in {kreg.config_sig(c) for c in kdef.space(kdef.smoke_shape)}
        assert row["t_model_s"] > 0 and 1 <= row["swept"] <= row["exhaustive"]


# ---------------------------------------------------------------------------
# the wall timer: one timing per launch key
# ---------------------------------------------------------------------------


def _counting(monkeypatch, name, launch_key=None):
    kdef = kreg.get_kernel(name)
    calls = []

    def call(shape, args, config):
        calls.append(kreg.config_sig(config))
        return kdef.call(shape, args, config)

    fields = {"call": call}
    if launch_key is not None:
        fields["launch_key"] = launch_key
    monkeypatch.setitem(kreg.KERNELS, name, dataclasses.replace(kdef, **fields))
    return calls


def _fake_clock(monkeypatch):
    """perf_counter as a counter: every timed call takes one second, so
    every candidate ties and the canonical first wins."""
    ticks = iter(range(1 << 30))
    monkeypatch.setattr(tat.time, "perf_counter", lambda: float(next(ticks)))


def test_wall_timer_times_one_candidate_per_launch_key(monkeypatch):
    """The flash_attention smoke tier's survivors map to three tf32x3
    variants (k rows 16, 32 and 64 a streamed tile): the sweep runs the
    canonical first config of each launch key, warm-up plus reps, and gives
    its time to every config sharing the key."""
    name, shape = "flash_attention", _shape("flash_attention", "smoke")
    kdef = kreg.get_kernel(name)
    calls = _counting(monkeypatch, name)
    _fake_clock(monkeypatch)
    tuner = Autotuner(timer="wall", device="cpu", reps=2, warmup=1)
    survivors, _ = tuner.prune(name, shape)
    first = {}
    for c in survivors:
        first.setdefault(kdef.launch_key(shape, c, "float32"), kreg.config_sig(c))
    assert len(survivors) > len(first) > 1
    assert tuner.variants(name, shape, "float32", survivors) == []  # the frontier reaches every variant
    result = tuner.tune(name, shape)
    assert sorted(calls) == sorted(3 * list(first.values()))
    assert result.timed == len(first)
    assert result.config == survivors[0]
    assert set(result.timings) == {kreg.config_sig(c) for c in survivors}
    for c in survivors:
        assert result.timings[kreg.config_sig(c)] == result.timings[first[kdef.launch_key(shape, c, "float32")]]


def test_wall_timer_times_each_distinct_launch_key(monkeypatch):
    """With a launch a config, the survivors are timed and so is every
    other config of the space, each the one config of its launch key (the
    model, which prices the reference's tiling, rules out no launch)."""
    name, shape = "flash_attention", _shape("flash_attention", "smoke")
    calls = _counting(monkeypatch, name, launch_key=lambda s, c, d: (kreg.config_sig(c),))
    tuner = Autotuner(timer="wall", device="cpu", reps=2, warmup=1)
    survivors, _ = tuner.prune(name, shape)
    space = kreg.get_kernel(name).space(shape)
    result = tuner.tune(name, shape)
    assert len(calls) == 3 * len(space) and result.timed == len(space)
    assert result.swept == len(survivors) < len(space)
    assert set(result.timings) == {kreg.config_sig(c) for c in space}
    assert result.best_s == min(result.timings.values())


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
def test_wall_sweep_times_every_launch_of_the_full_tier(monkeypatch, name):
    """At each kernel's full tier the wall sweep runs every fp32 variant
    the space reaches, at least two, one candidate each: the frontier's,
    then for each variant it misses that variant's best-modeled config."""
    kdef = kreg.get_kernel(name)
    shape = _shape(name, "full")
    keys = {kdef.launch_key(shape, c, "float32") for c in kdef.space(shape)}
    calls = _counting(monkeypatch, name)
    _fake_clock(monkeypatch)
    tuner = Autotuner(timer="wall", device="cpu", reps=1, warmup=0)
    survivors, _ = tuner.prune(name, shape)
    added = tuner.variants(name, shape, "float32", survivors)
    assert {kdef.launch_key(shape, c, "float32") for c in survivors + added} == keys
    result = tuner.tune(name, shape)
    assert result.timed == len(keys) == len(calls) >= 2 and len(set(calls)) == len(keys)
    assert result.swept == len(survivors)
    for c in added:  # no config of its launch key is modeled faster
        same = [o for o in kdef.space(shape) if kdef.launch_key(shape, o, "float32") == kdef.launch_key(shape, c, "float32")]
        assert all(tuner.model_time_s(kdef.tile_cost(shape, o, "float32")) >= tuner.model_time_s(kdef.tile_cost(shape, c, "float32"))
                   for o in same)


# the launcher module whose ``tile`` each kernel's launch key reads
TILES = {"flash_attention": tfa, "selective_scan": tss, "rglru_scan": trg, "moe_gmm": tgmm}
# the tiles the kernels were compiled with before they took a config
# (csrc/rglru_scan.cu DC 32; csrc/selective_scan.cu DC 32;
# csrc/flash_attention.cu kRows 64 and BN 32; csrc/gmm.cuh tf32x3 BN 128, STAGES 3)
TODAYS_TILES = {"rglru_scan": (32,), "selective_scan": (32,), "flash_attention": (64, 32), "moe_gmm": (128, 3)}
ROUTES = {"flash_attention": "tf32x3", "moe_gmm": "tf32x3", "selective_scan": "cuda", "rglru_scan": "cuda"}


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
def test_launch_keys_are_the_route_and_the_tile(name):
    """A launch key is the route and the variant the launcher's ``tile``
    maps the config to (attention's blocks clamped to L first, as the
    registry's call hands them to ``ops``).  The routes without a knob keep
    one key: the bf16 GEMM and attention on ``wgmma``, the GEMM's ``mma``,
    fp32 attention at hd 256 on ``tf32x3_cluster``."""
    kdef = kreg.get_kernel(name)
    for tier in TIERS:
        shape = _shape(name, tier)
        for c in kdef.space(shape):
            seen = c
            if name == "flash_attention":
                seen = {k: min(v, shape["L"]) for k, v in c.items()}
            want = (ROUTES[name],) + TILES[name].tile(shape, seen, torch.float32)
            assert kdef.launch_key(shape, c, "float32") == want, (tier, c)
    if name == "moe_gmm":
        assert kdef.launch_key({"E": 1, "C": 64, "D": 128, "F": 128}, kdef.defaults({}), "bfloat16") == ("wgmma",)
        assert kdef.launch_key({"E": 1, "C": 64, "D": 128, "F": 50}, kdef.defaults({}), "float32") == ("mma",)
    if name == "flash_attention":
        shape = {**_shape(name, "smoke"), "hd": 256}
        assert {kdef.launch_key(shape, c, "float32") for c in kdef.space(shape)} == {("tf32x3_cluster",)}
        assert {kdef.launch_key(_shape(name, "smoke"), c, "bfloat16") for c in kdef.space(shape)} == {("wgmma",)}


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
def test_the_default_config_launches_todays_tile(name):
    kdef = kreg.get_kernel(name)
    for tier in TIERS:
        shape = _shape(name, tier)
        assert TILES[name].tile(shape, kdef.defaults(shape), torch.float32) == TODAYS_TILES[name], tier
        assert kdef.launch_key(shape, kdef.defaults(shape), "float32") == (ROUTES[name],) + TODAYS_TILES[name]


# the exp14 demo problems (benchmarks/kernels_bench.py: DEMO_SHAPES)
EXP14 = [("rglru_scan", {"B": 1, "L": 64, "dr": 1024}), ("selective_scan", {"B": 1, "chunk": 32, "di": 1024, "N": 8})]


@pytest.mark.parametrize("name,shape", EXP14)
def test_exp14_shapes_sweep_distinct_launches(monkeypatch, name, shape):
    """At the exp14 demo shapes each scan's space maps to at least three
    variants (four: 8, 16, 32 and 64 channels a block).  The pruner keeps
    one survivor there, the widest block whose reference tiles fit (the
    reference's frontier collapses on the scans), whose variant is not the
    default's; the wall timer runs it and one candidate of each other
    variant, so the default's variant is timed too, and the pruner's cut
    (``swept``) stays the reference's."""
    kdef = kreg.get_kernel(name)
    space = kdef.space(shape)
    keys = {kdef.launch_key(shape, c, "float32") for c in space}
    assert len(keys) >= 3
    tuner = Autotuner(timer="wall", device="cpu", reps=2, warmup=1)
    (survivor,), _ = tuner.prune(name, shape)
    assert kdef.launch_key(shape, survivor, "float32") != kdef.launch_key(shape, kdef.defaults(shape), "float32")
    calls = _counting(monkeypatch, name)
    _fake_clock(monkeypatch)
    result = tuner.tune(name, shape)
    assert len(calls) == 3 * len(keys) and len(set(calls)) == len(keys) == result.timed
    assert kreg.config_sig(kdef.defaults(shape)) in result.timings
    assert {kdef.launch_key(shape, c, "float32") for c in space if kreg.config_sig(c) in result.timings} == keys
    assert result.swept == 1 and result.sweep_cut >= 2.0
    assert result.config == survivor  # every launch ties on the fake clock: the frontier's first wins


def _producible(name: str) -> set:
    """Every (shape, tile) the mapping gives at the registry's tiers and
    the exp14 shapes, in both dtypes, and at every head width and state
    width a route is built for."""
    kdef = kreg.get_kernel(name)
    shapes = [_shape(name, t) for t in TIERS] + [s for n, s in EXP14 if n == name]
    if name == "flash_attention":
        shapes += [{**s, "hd": hd} for s in list(shapes) for hd in tfa.ROUTE_DIMS[torch.float32]["tf32x3"]]
    if name == "selective_scan":
        shapes += [{**s, "N": n} for s in list(shapes) for n in (1, 4, 8, 16, 32, 33, 64)]
    out = set()
    for shape in shapes:
        for c in kdef.space(shape) + [kdef.defaults(shape)]:
            for dtype in (torch.float32, torch.bfloat16):
                out.add((tuple(sorted(shape.items(), key=str)), TILES[name].tile(shape, c, dtype), dtype))
    return out


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
def test_every_tile_the_mapping_gives_fits_a_block(name):
    """Each variant the mapping can produce fits 227 KB of shared memory by
    the arithmetic the CUDA source lays out (each launcher module's
    ``smem_bytes``, named in the source's comment), and the scan's blocks
    hold at most 512 threads.  A block the route cannot hold maps to the
    nearest one it can: attention at head width 128 takes 32 k rows for 64."""
    for shape, t, dtype in _producible(name):
        shape = dict(shape)
        if not t:
            continue
        if name == "rglru_scan":
            need = trg.smem_bytes(*t)
        elif name == "selective_scan":
            need = tss.smem_bytes(t[0], shape["N"], dtype)
            assert t[0] * max(4, 1 << (shape["N"] - 1).bit_length()) // 4 <= tss.MAX_THREADS
        elif name == "flash_attention":
            need = tfa.smem_bytes(shape["hd"], t[1], dtype)
        else:
            need = tgmm.smem_bytes(*t)
        assert need <= tat.SMEM_BUDGET_BYTES, (shape, t, need)
    assert tfa.tile({"hd": 128}, {"block_q": 128, "block_k": 512}) == (64, 32)
    assert tfa.smem_bytes(128, 64) > tat.SMEM_BUDGET_BYTES >= tfa.smem_bytes(64, 64)
    assert tss.tile({"N": 64}, {"block_d": 1024}) == (32,) and tss.tile({"N": 32}, {"block_d": 1024}) == (64,)


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
def test_larger_blocks_never_map_to_smaller_tiles(name):
    kdef = kreg.get_kernel(name)
    shape = _shape(name, "full")
    for a in kdef.space(shape):
        for b in kdef.space(shape):
            if all(b[k] >= a[k] for k in a):
                ta, tb = (TILES[name].tile(shape, c, torch.float32) for c in (a, b))
                assert all(y >= x for x, y in zip(ta, tb)), (a, b, ta, tb)


# ---------------------------------------------------------------------------
# broker wiring
# ---------------------------------------------------------------------------


def _kernel_broker(tmp_path) -> Hydra:
    h = Hydra(pod_store="memory", streaming=True, batch_window=0.0, workdir=str(tmp_path), device="cpu")
    h.register_provider(ProviderSpec(name="a", concurrency=2))
    return h


def test_broker_kernel_tasks_consult_tuned_cache_under_gate(tmp_path, monkeypatch):
    h = _kernel_broker(tmp_path)
    tuner = h.enable_kernel_autotune(timer="model")
    assert tuner.device == torch.device("cpu")
    kdef = kreg.get_kernel("rglru_scan")
    tuned = tuner.tune("rglru_scan", dict(kdef.tiny_shape), "float32")
    assert tuned.key.startswith("tune:rglru_scan:cpu:")
    default_sig = kreg.config_sig(kdef.defaults(kdef.tiny_shape))
    assert kreg.config_sig(tuned.config) != default_sig

    monkeypatch.setenv("HYDRA_AUTOTUNE", "1")
    gated = Task(kind="kernel", payload={"kernel": "rglru_scan"})
    h.dispatch([gated])
    assert wait_until(gated.done, timeout=60.0)
    assert gated.result()["config"] == kreg.config_sig(tuned.config)

    monkeypatch.delenv("HYDRA_AUTOTUNE")
    ungated = Task(kind="kernel", payload={"kernel": "rglru_scan"})
    h.dispatch([ungated])
    assert wait_until(ungated.done, timeout=60.0)
    assert ungated.result()["config"] == default_sig

    assert len([e for e in h.events.events() if e.name == "kernel.tune"]) == 1
    assert h.events.view.get("hydra.kernel.tunes") == 1
    h.shutdown(wait=True)
    assert tat._GLOBAL is not tuner


def test_enable_kernel_autotune_refuses_double_attach(tmp_path):
    h = _kernel_broker(tmp_path)
    h.enable_kernel_autotune(timer="model")
    with pytest.raises(RuntimeError):
        h.enable_kernel_autotune(timer="model")
    h.shutdown(wait=True)
