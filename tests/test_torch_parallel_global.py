"""Data-parallel training of the losses that do not split over the batch
(``batch_reduction = "global"``): the Frobenius flow and plate losses, the
eikonal loss and IBN resmin with a VAE. Each module sums its loss's parts
over 'data' with the differentiable all-reduce before the root, so every
rank computes the global batch's loss; the Trainer averages the gradients
(each rank's backward carries the all-reduce's share) and keeps the loss.
One Adam step of each over 4 gloo CPU ranks (2 rows a rank) against the
port's single process on the global batch of 8; the JAX package's tests
pin no data-mesh gradient of these modules (its single-process losses are
held to the port's in tests/test_torch_flow.py, test_torch_elasticity.py,
test_torch_eikonal.py and test_torch_ibn.py).

One module-scoped spawn of 4 ranks (tests/torch_solver_ranks.py::
global_rank). Each batch's samples differ (random interior Dirichlet nodes
for the flow and the plate, their own clouds for the eikonal and IBN
losses), so a loss that took a root of one rank's rows would fail.

Tolerances: the loss at rtol 1e-5; the all-reduced gradient entry by entry
within 1e-5 x its largest entry (sums of the same terms in another order,
four partial sums); the parameters after the step at atol 1e-6 (Adam moves
each by ~lr = 1e-3 times g / |g|); after a 5-iteration LBFGS step of the
plate, whose line search reads only global losses and gradients, the
fields within 1e-4 of their largest entry and the loss at rtol 1e-4 (as
tests/test_torch_parallel.py holds its LBFGS epoch). The epoch's
validation loss on the global batch, from a loader on no mesh (every rank
the whole batch, no reduction) after the Adam steps and from one on the
data mesh after the LBFGS step, at the loss's rtol of its step.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from diffnet_tpu_torch.data import SyntheticPointClouds
from diffnet_tpu_torch.data.flow import NSLDCDataset
from diffnet_tpu_torch.data.geometry_datasets import ElasticFSDTDataset
from diffnet_tpu_torch.models import VAE
from diffnet_tpu_torch.parallel import run_ranks
from tests import torch_solver_ranks as ranks

WORLD = 4
N, BATCH = 16, 8
MODULES = ("flow", "plate", "eikonal", "vae")


def _masks(base, rng, channel):
    """`base` inputs [n, n, C] for BATCH samples, each with its own random
    interior nodes added to the Dirichlet mask `channel`."""
    x = np.repeat(base[None], BATCH, 0).astype(np.float32)
    extra = rng.random((BATCH, N, N)) < 0.08
    x[..., channel] = np.maximum(x[..., channel], extra)
    return x


def _circles(rng):
    """BATCH clouds of 40 points on circles: points, unit normals."""
    t = rng.random((BATCH, 40)) * 2 * np.pi
    r = 0.15 + 0.2 * rng.random((BATCH, 1))
    c = 0.35 + 0.3 * rng.random((BATCH, 1, 2))
    nrm = np.stack([np.cos(t), np.sin(t)], -1)
    return np.concatenate([c + r[..., None] * nrm, nrm], -1
                          ).astype(np.float32)


def _payload():
    rng = np.random.default_rng(11)
    ldc = NSLDCDataset(domain_sizes=(N, N), Re=100)[0][0]
    plate = ElasticFSDTDataset(domain_size=N)
    clouds = SyntheticPointClouds(n_samples=BATCH, n_points=48,
                                  domain_size=N, seed=3)
    cloud_batch = tuple(np.stack([clouds[i][k] for i in range(BATCH)])
                        for k in range(3))
    vae = VAE(1, 1, dims=2, n_downsample=2, latent_channels=4)
    zeros = np.zeros((BATCH, N, N, 1), np.float32)
    return {
        "n": N, "batch": BATCH,
        "field0": (0.1 * rng.standard_normal((N, N))).astype(np.float32),
        "vae": {k: v.numpy() for k, v in vae.state_dict().items()},
        "batches": {
            "flow": (_masks(ldc, rng, 2), zeros),
            "plate": (_masks(plate.inputs, rng, 3),
                      np.repeat(plate.forcing[None], BATCH, 0)),
            "eikonal": (_circles(rng), zeros),
            "vae": cloud_batch}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    p = _payload()
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, ranks.global_rank, WORLD, (p,),
                              init_method=init, timeout=120.0, threads=1)
        one = {name: ranks.global_fit(name, p) for name in MODULES}
        one["plate_lbfgs"] = ranks.global_fit("plate", p, None, "lbfgs")
        out = spawned.result()
    return out, one


@pytest.mark.parametrize("name", MODULES)
def test_global_loss_and_gradient_match_one_process(results, name):
    """Every rank's loss and all-reduced gradient of the step against one
    process on the global batch."""
    out, one = results
    want = one[name]
    assert want["reduction"] == "global"
    for o in out:
        got = o[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        scale = max(np.abs(g).max() for g in want["grad"].values())
        for k, g in want["grad"].items():
            np.testing.assert_allclose(got["grad"][k], g, rtol=0,
                                       atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name", MODULES)
def test_global_adam_step_matches_one_process(results, name):
    """The parameters after the data-parallel Adam step, the same on every
    rank and as one process's, where the step is determined: an entry
    whose gradient lies within the gradient check's tolerance of 0 (the
    VAE's conv biases before an instance norm, gradients of rounding size)
    steps by ~lr times its rounding's sign, which no tolerance holds."""
    out, one = results
    want = one[name]
    scale = max(np.abs(g).max() for g in want["grad"].values())
    for o in out:
        for k, v in want["params"].items():
            sure = np.abs(want["grad"][k]) > 1e-5 * scale
            np.testing.assert_allclose(o[name]["params"][k][sure], v[sure],
                                       rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(o[name]["params"][k],
                                          out[0][name]["params"][k])


@pytest.mark.parametrize("name", MODULES + ("plate_lbfgs",))
def test_global_validation_loss_matches_one_process(results, name):
    """The validation loss after the step, the global batch's on every
    rank: whole on every rank (no reduction over 'data') after the Adam
    steps, and summed over 'data' from each rank's rows after the LBFGS
    step."""
    out, one = results
    rtol = 1e-4 if name == "plate_lbfgs" else 1e-5
    for o in out:
        np.testing.assert_allclose(o[name]["val_loss"],
                                   one[name]["val_loss"], rtol=rtol)


def test_global_lbfgs_step_matches_one_process(results):
    """A 5-iteration LBFGS step of the plate over 'data': every rank's line
    search takes the one-process steps (the same fields on every rank)."""
    out, one = results
    want = one["plate_lbfgs"]
    for o in out:
        got = o["plate_lbfgs"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-4 * np.abs(v).max(),
                                       err_msg=k)
            np.testing.assert_array_equal(got["params"][k],
                                          out[0]["plate_lbfgs"]["params"][k])
