"""The port's precision study (``diffnet_tpu_torch.examples.
precision_study``) against scripts/precision_study.py on the CPU, at small
sizes.

Tolerances, each against JAX's figure on the same inputs:
- section 1 (bf16 against float32 residual, library policy) at 32^2:
  within 1e-2 relative (XLA's and torch's bf16 contractions round in
  another order: 1.7e-3 apart at 32^2, equal to 1e-7 at 128^2);
- section 2 (L-BFGS, 20 updates at 17^2; the port's ``ZoomLBFGS`` is
  optax's ``lbfgs()``, held update by update in
  tests/test_torch_lbfgs_zoom.py): f32 within 1e-3 relative (1.6e-4 on
  this CPU); the bf16 policies within 2x either way (bf16's rounding,
  summed in another order by XLA and torch, steers the curvature pairs:
  bf16-residual 0.98x and bf16-accum 1.46x of JAX's on this CPU), and
  below 0.95 where JAX's is: a field that never left its zero start (rel
  L2 1) fails;
- section 2b (Adam, 200 steps at 17^2): within 5e-2 relative (Adam from
  zeros amplifies float32 rounding where a gradient entry crosses zero:
  1.3% apart).
K1's route (float32) equals the library residual within 2e-6 x max(1,
max |R|), and its bf16 result is within 8e-3 x max(1, max |float32|)
(chip_smoke's BF16_ATOL)."""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_studies import (ROOT, jax_script,  # noqa: F401
                                      one_torch_thread)

ACC_REL = 1e-2
F32_REL = 1e-3
BF16_FACTOR = 2.0
MOVED = 0.95
ADAM_REL = 5e-2


@pytest.fixture(scope="module")
def jps():
    return jax_script("precision_study")


@pytest.fixture(scope="module")
def pps():
    from diffnet_tpu_torch.examples import precision_study

    return precision_study


def test_accuracy_vs_f32_matches_jax(jps, pps):
    ref = jps.accuracy_vs_f32(32)
    got = pps.accuracy_vs_f32(32, device="cpu")
    assert abs(got - ref) <= ACC_REL * ref, (got, ref)
    k1 = pps.accuracy_vs_f32(32, device="cpu", route="k1")
    assert 0 < k1 < 1e-2


def test_k1_route_is_the_residual(pps):
    n = 33
    dev = torch.device("cpu")
    basis = pps._basis(n, dev)
    u, nu, f = pps._fields(n, 2, dev)
    bc = torch.zeros((n, n))
    bc[0, :] = 1.0
    lib = pps.residual(u, nu, f, basis, n, bc)
    r32 = pps.residual_k1(u, nu, f, basis, n, bc)
    r16 = pps.residual_k1(u.bfloat16(), nu.bfloat16(), f.bfloat16(), basis,
                          n, bc)
    assert float((r32 - lib).abs().max()) <= 2e-6 * max(
        1.0, float(lib.abs().max()))
    assert r16.dtype == torch.bfloat16
    assert float((r16.float() - r32).abs().max()) <= 8e-3 * max(
        1.0, float(r32.abs().max()))


@pytest.mark.parametrize("policy", ["f32", "bf16-residual", "bf16-accum"])
def test_solve_mms_matches_jax(jps, pps, policy):
    ref = jps.solve_mms(17, policy, steps=20)
    got = pps.solve_mms(17, policy, steps=20, device="cpu")
    if policy == "f32":
        assert abs(got - ref) <= F32_REL * ref, (got, ref)
    else:
        assert ref / BF16_FACTOR <= got <= BF16_FACTOR * ref, (got, ref)
        assert ref >= MOVED or got < MOVED, (got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_solve_mms_adam_matches_jax(jps, pps, dtype):
    import jax.numpy as jnp

    ref = jps.solve_mms_adam(17, getattr(jnp, dtype), steps=200)
    got = pps.solve_mms_adam(17, getattr(torch, dtype), steps=200,
                             device="cpu")
    assert abs(got - ref) <= ADAM_REL * ref, (got, ref)


def test_throughput_only_default_out_under_runs(pps, tmp_path, monkeypatch):
    """--throughput-only at a tiny size: elements/s of both routes in both
    types, written to runs/precision/ of the working directory (never
    docs/MIXED_PRECISION.md), with the device named."""
    doc = os.path.join(ROOT, "docs", "MIXED_PRECISION.md")
    before = open(doc).read()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DIFFNET_BENCH_SIZE", "17")
    out = pps.main(["--throughput-only", "--fused-kernels", "--device",
                    "cpu"])
    path = tmp_path / "runs" / "precision" / "MIXED_PRECISION.md"
    assert os.path.abspath(out["out"]) == str(path)
    assert set(out["throughput"]) == {"library_float32", "library_bfloat16",
                                      "k1_float32", "k1_bfloat16"}
    assert all(np.isfinite(v) and v > 0 for v in out["throughput"].values())
    text = path.read_text()
    assert "## 3. Residual throughput at 17^2" in text and "the CPU" in text
    assert open(doc).read() == before
