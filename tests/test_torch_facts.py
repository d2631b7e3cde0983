"""The port's FACTS model and workflow (repro_torch/facts) against the reference.

``preprocess`` is numpy in both packages and must be bit-identical.  ``fit``
solves the same 2x2 ridge system in fp32 and must match at relative 1e-5.
``project`` draws with ``jax.random`` in the reference and with a
``torch.Generator`` in the port, which cannot give the same numbers; the
port's ``project_from_draws`` is therefore fed the reference's own draws
(the same key derivation, ``(seed << 16) ^ site`` split three ways) and must
give the same rise and trajectories at max-abs 1e-3 mm, and the same
post-processed quantiles.  Last, a 2-instance FACTS workflow runs through
the port's broker on the CPU.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.facts import model as jfacts
from repro_torch.core import Hydra, ProviderSpec
from repro_torch.core.managers.workflow import WorkflowManager
from repro_torch.facts import model as tfacts
from repro_torch.facts.workflow import FORCING_DATASET, make_workflow, result_of
from repro_torch.runtime.clock import virtual_time

torch.set_num_threads(1)

SITES = [(0, 0), (3, 0), (17, 5), (250, 2)]  # (site, seed)
FIT_RTOL = 1e-5
MM_TOL = 1e-3


def _reference_draws(pre, fitted, n_samples, seed):
    """The reference's three normal draws (repro/facts/model.py:79-96)."""
    key = jax.random.key((seed << 16) ^ fitted["site"])
    k1, k2, k3 = jax.random.split(key, 3)
    n_f = jfacts.YEAR_END - int(pre["years"][-1])
    return tuple(
        torch.from_numpy(np.array(jax.random.normal(k, shape)))
        for k, shape in ((k1, (n_samples, 2)), (k2, (n_samples, 1)), (k3, (n_samples, n_f)))
    )


@pytest.mark.parametrize("site,seed", SITES)
def test_preprocess_is_bit_identical(site, seed):
    ref, port = jfacts.preprocess(site, seed), tfacts.preprocess(site, seed)
    assert ref.keys() == port.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(port[k]), np.asarray(ref[k]))


@pytest.mark.parametrize("site,seed", SITES)
def test_fit_matches_the_reference(site, seed):
    pre = jfacts.preprocess(site, seed)
    ref, port = jfacts.fit(pre), tfacts.fit(pre, device="cpu")
    assert port["site"] == ref["site"]
    np.testing.assert_allclose(port["theta"], ref["theta"], rtol=FIT_RTOL)
    np.testing.assert_allclose(port["cov"], ref["cov"], rtol=FIT_RTOL)
    np.testing.assert_allclose(port["sigma2"], ref["sigma2"], rtol=FIT_RTOL)


@pytest.mark.parametrize("site,seed", SITES)
def test_projection_from_the_references_draws_matches_it(site, seed):
    n = 500
    pre = jfacts.preprocess(site, seed)
    fitted = jfacts.fit(pre)
    ref = jfacts.project(pre, fitted, n_samples=n, seed=seed)
    port = tfacts.project_from_draws(pre, fitted, *_reference_draws(pre, fitted, n, seed))
    assert port["site"] == ref["site"]
    np.testing.assert_array_equal(port["years"], ref["years"])
    assert port["rise_mm"].shape == ref["rise_mm"].shape == (n,)
    assert port["trajectories"].shape == ref["trajectories"].shape
    assert np.abs(port["rise_mm"] - ref["rise_mm"]).max() <= MM_TOL
    assert np.abs(port["trajectories"] - ref["trajectories"]).max() <= MM_TOL
    qp, qr = tfacts.postprocess(port), jfacts.postprocess(ref)
    assert qp["quantiles"].keys() == qr["quantiles"].keys()
    assert max(abs(qp["quantiles"][k] - qr["quantiles"][k]) for k in qr["quantiles"]) <= MM_TOL
    assert abs(qp["mean_mm"] - qr["mean_mm"]) <= MM_TOL


def test_postprocess_is_the_references():
    proj = {"site": 4, "rise_mm": np.random.default_rng(0).normal(300.0, 40.0, 2000)}
    assert tfacts.postprocess(proj) == jfacts.postprocess(proj)


def test_port_draws_are_seeded_and_shaped_like_the_references():
    pre = tfacts.preprocess(5, 1)
    fitted = tfacts.fit(pre, device="cpu")
    a = tfacts.draws(pre, fitted, n_samples=64, seed=1, device="cpu")
    b = tfacts.draws(pre, fitted, n_samples=64, seed=1, device="cpu")
    c = tfacts.draws(pre, fitted, n_samples=64, seed=2, device="cpu")
    ref = _reference_draws(pre, fitted, 64, 1)
    assert [x.shape for x in a] == [x.shape for x in ref]
    assert all(x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    proj = tfacts.project(pre, fitted, n_samples=64, seed=1, device="cpu")
    again = tfacts.project_from_draws(pre, fitted, *a)
    np.testing.assert_array_equal(proj["rise_mm"], again["rise_mm"])
    # a different stream of the same distribution: the ensembles agree in
    # their mean to within a few standard errors, not sample by sample
    big = tfacts.project(pre, fitted, n_samples=4000, seed=1, device="cpu")
    jbig = jfacts.project(pre, fitted, n_samples=4000, seed=1)
    se = np.hypot(big["rise_mm"].std(), jbig["rise_mm"].std()) / np.sqrt(4000)
    assert abs(big["rise_mm"].mean() - jbig["rise_mm"].mean()) <= 6 * se


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default device where no card is visible")
def test_fit_and_project_default_to_the_card():
    pre = tfacts.preprocess(1)
    with pytest.raises((RuntimeError, AssertionError)):
        tfacts.fit(pre)
    fitted = tfacts.fit(pre, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        tfacts.project(pre, fitted)


def test_two_instance_workflow_runs_through_the_port_broker(tmp_path):
    """With the staging registry, as tests/test_facts.py runs it: under a
    virtual clock, so the modeled 2 GB forcing pull costs no real time."""
    with virtual_time():
        h = Hydra(device="cpu", pod_store="memory", policy="data_gravity", streaming=True,
                  batch_window=0.001, workdir=str(tmp_path))
        h.register_provider(ProviderSpec(name="cloud", platform="cloud", concurrency=4))
        h.register_provider(ProviderSpec(name="hpc", platform="hpc", connector="pilot", concurrency=4))
        wfs = [make_workflow(h.data, i, seed=3, n_samples=256, registry=h.staging.registry, device="cpu") for i in range(2)]
        assert all(t.inputs for wf in wfs for t in wf.tasks)
        WorkflowManager(h).run(wfs, wait=True, timeout=300.0)
        assert all(wf.done and not wf.failed for wf in wfs)
        assert h.staging_stats()["stage_outs"] == 8
        assert h.staging.registry.locate(FORCING_DATASET)
        results = [result_of(h.data, i) for i in range(2)]
        h.shutdown(wait=True)
    for i, out in enumerate(results):
        q = [out["quantiles"][k] for k in ("p5", "p17", "p50", "p83", "p95")]
        assert np.all(np.isfinite(q)) and q == sorted(q)
        # the same instance computed directly, on the same device and seed
        pre = tfacts.preprocess(i, 3)
        fitted = tfacts.fit(pre, device="cpu")
        assert out == tfacts.postprocess(tfacts.project(pre, fitted, n_samples=256, seed=3, device="cpu"))
