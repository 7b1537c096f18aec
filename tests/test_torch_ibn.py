"""The port's IBN path against the JAX package's, on the same numpy inputs:
geometry (winding numbers, chi, cloud samplers), the parametric datasets,
the loader's whole-batch path and prefetch, ``IBNPoisson2D``'s losses,
boundary handling, point-cloud network inputs and direct solve, ``lr_milestones``, a 5-step training
run, the query tools and the export round trip.

Tolerances: winding numbers within 1e-5 absolute of JAX's (sums of ~1e2
float32 terms in other orders) or, on a node grid, within 1e-5 of the
float64 winding number or no further from it than JAX's float32 result:
next to a cloud point w is steep, and float32's rounding of p - q alone
moves it by up to ~1e-4 in either package; chi equal at every node with
|w - 0.5| > 1e-4;
cloud samplers and datasets bit-equal (the same numpy code); losses and
their gradients within 1e-5 relative (gradients of their largest entry);
the 5-step training trajectory within 1e-4 relative.
"""

import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffnet_tpu.core import geometry as jgeo
from diffnet_tpu.data import parametric as jpar
from diffnet_tpu.data.loader import InMemoryDataset as JInMemoryDataset
from diffnet_tpu.data.loader import NumpyLoader as JNumpyLoader
from diffnet_tpu.models import pointnets as jpn
from diffnet_tpu.models.networks import AE as JAE
from diffnet_tpu.models.networks import VAE as JVAE
from diffnet_tpu.pde.ibn import IBNPoisson2D as JIBNPoisson2D
from diffnet_tpu.train.linear import module_linear_solve as jsolve
from diffnet_tpu.train.query import query_batched as jquery_batched
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.core import geometry as tgeo
from diffnet_tpu_torch.data import parametric as tpar
from diffnet_tpu_torch.data.loader import InMemoryDataset, NumpyLoader
from diffnet_tpu_torch.interop import params_from_jax
from diffnet_tpu_torch.models import (AE, DGCNN2D, VAE,
                                      ImmDiffLargeNormals)
from diffnet_tpu_torch.pde import IBNPoisson2D
from diffnet_tpu_torch.train import (Callback, Trainer, make_run_dir,
                                     module_linear_solve, query_batched,
                                     query_statistical)
from diffnet_tpu_torch.utils import (export_forward, load_exported,
                                     save_exported)

from .test_torch_networks import flax_params

W_ATOL = 1e-5
BAND = 1e-4
LOSS_RTOL = 1e-5
TRAJ_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cloud_args(pts, nrm, area):
    return tuple(np.asarray(a)[None] for a in (pts, nrm, area))


# -- geometry ---------------------------------------------------------------

def test_winding_2d_matches_jax_and_chunking():
    """The cloud and queries of the JAX package's chunking test: the port's
    winding number equals JAX's, and its chunks do not change it."""
    args = _cloud_args(*jgeo.sample_ellipse_cloud(n_points=64))
    q = np.random.default_rng(0).uniform(0, 1, (500, 2)).astype(np.float32)
    wj = np.asarray(jgeo.winding_number_2d(*map(jnp.asarray, args),
                                           jnp.asarray(q), chunk=500))
    w500 = tgeo.winding_number_2d(*map(_t, args), _t(q), chunk=500)
    w64 = tgeo.winding_number_2d(*map(_t, args), _t(q), chunk=64)
    assert w500.shape == (1, 500)
    np.testing.assert_allclose(w500.numpy(), wj, atol=W_ATOL)
    np.testing.assert_allclose(w64.numpy(), w500.numpy(), atol=W_ATOL)


@pytest.mark.parametrize("kind", ["ellipse_256", "synthetic_batch"])
def test_chi_matches_jax_outside_the_band(kind):
    """chi = (w > 0.5) equals JAX's at every node where |w - 0.5| > 1e-4
    (the two packages sum in other orders); for these ellipse clouds no
    node lies in that band."""
    if kind == "ellipse_256":   # the JAX package's occupancy test cloud
        args = _cloud_args(*jgeo.sample_ellipse_cloud(
            n_points=256, center=(0.5, 0.5), radii=(0.3, 0.2)))
        shape = (32, 32)
    else:
        ds = tpar.SyntheticPointClouds(n_samples=6, n_points=64,
                                       domain_size=24, seed=0)
        cloud = np.stack([ds[i][0] for i in range(6)])
        args = (cloud[..., 0:2], cloud[..., 2:4], cloud[..., 4])
        shape = (24, 24)
    wj = np.asarray(jgeo.winding_grid(*map(jnp.asarray, args), shape))
    chij = np.asarray(jgeo.occupancy_from_cloud(*map(jnp.asarray, args),
                                                shape))
    # the float64 winding number at the float32 nodes both packages use
    x = np.asarray(jnp.linspace(0, 1, shape[1]))
    assert np.array_equal(tgeo._linspace(1.0, shape[1], _t(x)).numpy(), x)
    xx, yy = np.meshgrid(x, x)
    q = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float64)
    with jax.enable_x64(True):
        w64 = np.asarray(jgeo.winding_number_2d(
            *(jnp.asarray(a, jnp.float64) for a in args), jnp.asarray(q)))
    w64 = w64.reshape(wj.shape)
    wt = tgeo.winding_grid(*map(_t, args), shape).numpy()
    chit = tgeo.occupancy_from_cloud(*map(_t, args), shape).numpy()
    assert w64.dtype == np.float64
    err, err_jax = np.abs(wt - w64), np.abs(wj - w64)
    assert np.all(err <= np.maximum(W_ATOL, err_jax)), \
        (err.max(), err_jax.max())
    outside = np.abs(wj - 0.5) > BAND
    assert np.array_equal(chit[outside], chij[outside])
    assert int((~outside).sum()) == 0
    assert chit.dtype == np.float32 and 0 < chit.mean() < 0.5


def test_winding_grid_gradient_in_the_cloud():
    """The raw winding field is differentiable in the cloud (points,
    normals, areas), as JAX's."""
    pts, nrm, area = _cloud_args(*jgeo.sample_ellipse_cloud(n_points=48))
    r = np.random.default_rng(2).standard_normal((1, 16, 16)).astype(
        np.float32)

    def jf(p, n, a):
        return jnp.sum(jgeo.winding_grid(p, n, a, (16, 16)) * r)

    gj = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (pts, nrm, area)))
    tp = [_t(a).requires_grad_() for a in (pts, nrm, area)]
    torch.sum(tgeo.winding_grid(*tp, (16, 16)) * _t(r)).backward()
    for a, b in zip(gj, tp):
        a = np.asarray(a)
        np.testing.assert_allclose(b.grad.numpy(), a,
                                   atol=LOSS_RTOL * np.abs(a).max())


def test_winding_3d_and_occupancy_match_jax():
    pts, nrm, area = _cloud_args(*jgeo.sample_sphere_cloud(
        n_points=300, radius=0.3))
    q = np.random.default_rng(1).uniform(0, 1, (400, 3)).astype(np.float32)
    wj = np.asarray(jgeo.winding_number_3d(
        *map(jnp.asarray, (pts, nrm, area)), jnp.asarray(q)))
    wt = tgeo.winding_number_3d(*map(_t, (pts, nrm, area)), _t(q), chunk=96)
    np.testing.assert_allclose(wt.numpy(), wj, atol=W_ATOL)
    shape = (9, 10, 11)
    chij = np.asarray(jgeo.occupancy_from_cloud_3d(
        *map(jnp.asarray, (pts, nrm, area)), shape))
    chit = tgeo.occupancy_from_cloud_3d(*map(_t, (pts, nrm, area)),
                                        shape).numpy()
    assert chit.shape == (1,) + shape
    # the sphere's node grid keeps clear of w = 0.5 (|w - 0.5| > 0.05)
    assert np.array_equal(chit, chij) and 0 < chit.mean() < 0.5


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_cloud_samplers_are_bit_equal():
    verts = [(0.3, 0.3), (0.7, 0.3), (0.6, 0.7), (0.3, 0.6)]
    _same_arrays(jgeo.sample_polygon_cloud(verts, 7),
                 tgeo.sample_polygon_cloud(verts, 7))
    _same_arrays(jgeo.sample_ellipse_cloud(33, (0.4, 0.6), (0.2, 0.1), 0.3,
                                           np.random.default_rng(5)),
                 tgeo.sample_ellipse_cloud(33, (0.4, 0.6), (0.2, 0.1), 0.3,
                                           np.random.default_rng(5)))
    _same_arrays(jgeo.sample_sphere_cloud(50),
                 tgeo.sample_sphere_cloud(50))
    _same_arrays(jgeo.sample_sphere_cloud(50, rng=np.random.default_rng(1)),
                 tgeo.sample_sphere_cloud(50, rng=np.random.default_rng(1)))
    z, y, x = np.meshgrid(*(np.linspace(0, 1, n) for n in (10, 11, 12)),
                          indexing="ij")
    vox = ((x - 0.5)**2 + (y - 0.5)**2 + (z - 0.5)**2 < 0.1).astype(float)
    _same_arrays(jgeo.cloud_from_voxels(vox, (1.0, 1.2, 0.9)),
                 tgeo.cloud_from_voxels(vox, (1.0, 1.2, 0.9)))
    _same_arrays(jgeo.cloud_from_voxels(vox, max_points=20),
                 tgeo.cloud_from_voxels(vox, max_points=20))
    lin = [np.linspace(0, 1, n) for n in (3, 4, 5)]
    _same_arrays(jgeo.meshgrid_3d(*lin), tgeo.meshgrid_3d(*lin))


# -- datasets ---------------------------------------------------------------

def _same_samples(jds, tds):
    assert len(jds) == len(tds)
    for i in (0, len(jds) // 2, len(jds) - 1):
        _same_arrays(jds[i], tds[i])


def test_synthetic_point_clouds_are_bit_equal():
    kw = dict(n_samples=5, n_points=40, domain_size=16, seed=3)
    _same_samples(jpar.SyntheticPointClouds(**kw),
                  tpar.SyntheticPointClouds(**kw))


@pytest.mark.parametrize("split", ["train", "val"])
def test_point_clouds_from_npz_split_at_1250(tmp_path, split):
    """Archives of 1,262 clouds (written here: none is in the repository):
    the first 1,250 are the val split, the rest train."""
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "point_cloud.npz",
             rng.uniform(-0.5, 0.5, (1262, 20, 3)).astype(np.float32))
    np.savez(tmp_path / "normals.npz",
             rng.standard_normal((1262, 20, 3)).astype(np.float32))
    jds = jpar.PointClouds(str(tmp_path), split, domain_size=12)
    tds = tpar.PointClouds(str(tmp_path), split, domain_size=12)
    assert len(tds) == (1250 if split == "val" else 12)
    _same_samples(jds, tds)


@pytest.mark.parametrize("name", ["ImageIMBack", "ImageIMBackObject",
                                  "ImageIMBackNeumann"])
def test_image_datasets_match_jax(tmp_path, name):
    import PIL.Image

    rng = np.random.default_rng(0)
    for i in range(3):
        img = (rng.random((16, 16)) > 0.7).astype(np.uint8) * 255
        PIL.Image.fromarray(img).save(tmp_path / f"im{i}.png")
    _same_samples(getattr(jpar, name)(str(tmp_path), 16),
                  getattr(tpar, name)(str(tmp_path), 16))
    (tmp_path / "notes.txt").write_text("x")
    with pytest.raises(ValueError, match="extension"):
        getattr(tpar, name)(str(tmp_path), 16)


# -- loader -----------------------------------------------------------------

def _in_memory(n=10):
    rng = np.random.default_rng(0)
    return (rng.random((n, 4, 4, 3)).astype(np.float32),
            rng.random((n, 4, 4, 1)).astype(np.float32))


def test_in_memory_batch_equals_stacked_items():
    inputs, forcing = _in_memory()
    ds = InMemoryDataset(inputs, forcing)
    idx = np.array([3, 0, 9, -1, 4])
    got = ds.batch(idx)
    want = [np.stack([ds[int(i)][k] for i in idx]) for k in range(2)]
    _same_arrays(got, want)
    _same_arrays(got, JInMemoryDataset(inputs, forcing).batch(idx))
    with pytest.raises(ValueError):
        InMemoryDataset(inputs, forcing[:3])


class _NotABatch:
    """A dataset whose ``batch`` is an attribute, not a method."""

    batch = 5

    def __init__(self, n=7):
        self.x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.x[i] * 2


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("make", ["in_memory", "not_a_batch"])
def test_loader_batches_match_jax(make, prefetch):
    """The same batches, in the same shuffled order, as the JAX loader,
    through the whole-batch path (a callable ``batch``) or item by item,
    with and without prefetch; the last partial batch kept."""
    ds = InMemoryDataset(*_in_memory()) if make == "in_memory" \
        else _NotABatch()
    kw = dict(batch_size=3, shuffle=True, drop_last=False, seed=5)
    got = list(NumpyLoader(ds, prefetch=prefetch, **kw))
    want = list(JNumpyLoader(ds, **kw))
    assert len(got) == len(want) == math.ceil(len(ds) / 3)
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) for t in g)
        _same_arrays([t.numpy() for t in g], w)


class _Failing:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("sample 5 is unreadable")
        return (np.zeros(2, np.float32),)


def _wait_gone(threads, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if not any(t.is_alive() for t in threading.enumerate()
                   if t not in threads):
            return True
        time.sleep(0.02)
    return False


def test_prefetch_passes_a_dataset_exception_to_the_consumer():
    before = set(threading.enumerate())
    with pytest.raises(KeyError, match="unreadable"):
        list(NumpyLoader(_Failing(), batch_size=2, prefetch=1))
    assert _wait_gone(before)


def test_prefetch_thread_ends_when_the_consumer_leaves_early():
    """A consumer that takes one batch and leaves (fast_dev_run) releases
    the producer, which was blocked on the full queue."""
    before = set(threading.enumerate())
    it = iter(NumpyLoader(InMemoryDataset(*_in_memory(40)), batch_size=2,
                          prefetch=1))
    next(it)
    time.sleep(0.2)                # the producer fills the queue and waits
    assert any(t.is_alive() for t in threading.enumerate()
               if t not in before)
    it.close()
    assert _wait_gone(before)


# -- IBNPoisson2D -----------------------------------------------------------

def _masks(n, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    inputs = np.zeros((2, n, n, channels), np.float32)
    inputs[..., 0] = 0.5 + rng.random((2, n, n))
    inputs[0, 3:7, 4:8, 1] = 1.0
    inputs[1, 5:9, 2:5, 1] = 1.0
    if channels == 3:
        inputs[:, [0, -1], :, 2] = 1.0
        inputs[:, :, [0, -1], 2] = 1.0
    else:                       # Neumann: bc2 left and top, bc3 the rest
        inputs[:, :, 0, 2] = inputs[:, 0, :, 2] = 1.0
        inputs[:, :, -1, 3] = inputs[:, -1, :, 3] = 1.0
    forcing = rng.random((2, n, n, 1)).astype(np.float32)
    u = rng.random((2, n, n, 1)).astype(np.float32)
    return u, inputs, forcing


LOSS_CASES = {   # name -> (module kwargs, input channels)
    "energy": ({}, 3),
    "resmin": ({"ibn_loss_type": "resmin"}, 3),
    "energy_bc1_0": ({"bc1_value": 0.0}, 3),
    "neumann_energy": ({"neumann": True}, 4),
    "neumann_resmin": ({"neumann": True, "ibn_loss_type": "resmin"}, 4),
    "neumann_resmin_3ch": ({"neumann": True, "ibn_loss_type": "resmin"}, 3),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_apply_bcs_and_residual_match_jax(case):
    """loss (value and du), apply_bcs and residual_for_field on the same
    fields and masks, source_from='inputs'."""
    kw, ch = LOSS_CASES[case]
    n = 12
    u, inputs, forcing = _masks(n, ch)
    jm = JIBNPoisson2D(None, source_from="inputs", domain_size=n, **kw)
    tm = IBNPoisson2D(None, source_from="inputs", domain_size=n, **kw)
    ji, jf = jnp.asarray(inputs), jnp.asarray(forcing)
    lj, gj = jax.value_and_grad(lambda v: jm.loss(v, ji, jf))(jnp.asarray(u))
    tu = _t(u).requires_grad_()
    lt = tm.loss(tu, _t(inputs), _t(forcing))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    gj = np.asarray(gj)
    np.testing.assert_allclose(tu.grad.numpy(), gj,
                               atol=LOSS_RTOL * np.abs(gj).max())
    np.testing.assert_array_equal(
        tm.apply_bcs(_t(u), _t(inputs)).numpy(),
        np.asarray(jm.apply_bcs(jnp.asarray(u), ji)))
    rj = np.asarray(jm.residual_for_field(jnp.asarray(u), ji, jf))
    rt = tm.residual_for_field(_t(u), _t(inputs), _t(forcing)).numpy()
    np.testing.assert_allclose(rt, rj, atol=2e-6 * max(1, np.abs(rj).max()))


def _cloud_batch(n, bs=4, n_points=48, seed=0):
    ds = tpar.SyntheticPointClouds(n_samples=bs, n_points=n_points,
                                   domain_size=n, seed=seed)
    return tuple(np.stack([ds[i][k] for i in range(bs)]) for k in range(3))


def _net_pair(kind, n, batch):
    if kind == "vae":
        jnet = JVAE(out_channels=1, dims=2, n_downsample=2,
                    latent_channels=4)
        tnet = VAE(1, 1, dims=2, n_downsample=2, latent_channels=4)
    else:
        jnet = JAE(out_channels=1, dims=4, n_downsample=2)
        tnet = AE(1, 1, dims=4, n_downsample=2)
    x = np.zeros((batch[0].shape[0], n, n, 1), np.float32)
    params = jax.tree.map(np.asarray, flax_params(jnet, x))
    tnet.load_state_dict(params_from_jax(params))
    return jnet, tnet, params


TRAINING_CASES = {   # name -> (network, module kwargs)
    "energy": ("ae", {}),
    "resmin": ("ae", {"ibn_loss_type": "resmin"}),
    "mask": ("ae", {"ibn_loss_type": "mask"}),
    "vae_kl": ("vae", {"vae_kl_weight": 0.05}),
}


@pytest.mark.parametrize("case", list(TRAINING_CASES))
def test_training_loss_from_clouds_matches_jax(case):
    """training_loss on a batch of clouds (winding -> chi -> net -> loss,
    with the VAE's KL term or the mask regression) and its parameter
    gradients, with the flax weights carried across."""
    kind, kw = TRAINING_CASES[case]
    n = 16
    batch = _cloud_batch(n)
    jnet, tnet, params = _net_pair(kind, n, batch)
    jm = JIBNPoisson2D(jnet, domain_size=n, **kw)
    tm = IBNPoisson2D(tnet, domain_size=n, **kw)
    lj, gj = jax.jit(jax.value_and_grad(jm.training_loss))(
        jax.tree.map(jnp.asarray, params), tuple(map(jnp.asarray, batch)))
    lt = tm.training_loss(tuple(map(_t, batch)))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    gj = params_from_jax(jax.tree.map(np.asarray, gj))
    scale = max(float(g.abs().max()) for g in gj.values())
    for k, p in tm.network.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(),
                                   atol=LOSS_RTOL * scale, err_msg=k)


def test_forward_stacks_ones_chi_and_sink():
    n = 16
    batch = _cloud_batch(n)
    jnet, tnet, params = _net_pair("ae", n, batch)
    jm = JIBNPoisson2D(jnet, domain_size=n)
    tm = IBNPoisson2D(tnet, domain_size=n)
    uj, ij, fj = jm.forward(jax.tree.map(jnp.asarray, params),
                            tuple(map(jnp.asarray, batch)))
    with torch.no_grad():
        ut, it, ft = tm(tuple(map(_t, batch)))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ft.numpy(), batch[1])
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj),
                               atol=LOSS_RTOL * np.abs(np.asarray(uj)).max())


def _cloud_net_pair(kind, n, cloud):
    """A point-cloud network of the JAX package and of the port, the flax
    weights carried across."""
    npts = cloud.shape[1]
    if kind == "dgcnn":
        jnet = jpn.DGCNN2D(domain_size=n, k=6, lowest_size=8)
        tnet = DGCNN2D(2, domain_size=n, k=6, lowest_size=8)
        args = (cloud[..., 0:2],)
    else:
        jnet = jpn.ImmDiffLargeNormals(out_size=n)
        tnet = ImmDiffLargeNormals(npts, out_size=n)
        args = (cloud[..., 0:2], cloud[..., 2:4])
    params = jax.tree.map(np.asarray, flax_params(jnet, *args))
    tnet.load_state_dict(params_from_jax(params))
    return jnet, tnet, params


CLOUD_CASES = {   # name -> (network, module kwargs)
    "cloud": ("dgcnn", {"network_input": "cloud"}),
    "cloud_normals": ("normals", {"network_input": "cloud_normals"}),
    "cloud_mask": ("dgcnn", {"network_input": "cloud",
                             "ibn_loss_type": "mask"}),
    "cloud_normals_resmin": ("normals", {"network_input": "cloud_normals",
                                         "ibn_loss_type": "resmin"}),
}


@pytest.mark.parametrize("case", list(CLOUD_CASES))
def test_cloud_network_inputs_match_jax(case):
    """The point-cloud networks on winding batches: DGCNN2D takes the
    points, ImmDiffLargeNormals the points and normals; chi (or, for
    'mask', the raw winding field) is the target set as before. The
    training loss and its parameter gradients, then two Adam steps loss
    for loss, from the same weights and batch. Through DGCNN2D the float32
    loss lies 1e-5 to 5e-5 from its float64 value, and the gradients up to
    1e-3 of their largest entry, in either package: so the float32 loss
    and steps are held to 1e-4, and the gradients (and the loss again) in
    float64, within 1e-10."""
    kind, kw = CLOUD_CASES[case]
    n = 16
    batch = _cloud_batch(n)
    jnet, tnet, params = _cloud_net_pair(kind, n, batch[0])
    jm = JIBNPoisson2D(jnet, domain_size=n, **kw)
    tm = IBNPoisson2D(tnet, domain_size=n, **kw)
    lj = jax.jit(jm.training_loss)(jax.tree.map(jnp.asarray, params),
                                   tuple(map(jnp.asarray, batch)))
    with torch.no_grad():
        lt = tm.training_loss(tuple(map(_t, batch)))
    np.testing.assert_allclose(float(lt), float(lj), rtol=TRAJ_RTOL)
    with jax.enable_x64(True):
        lj, gj = jax.value_and_grad(jm.training_loss)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params),
            tuple(jnp.asarray(a, jnp.float64) for a in batch))
        lj, gj = float(lj), params_from_jax(jax.tree.map(np.asarray, gj))
    lt = tm.double().training_loss(tuple(_t(a).double() for a in batch))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), lj, rtol=1e-10)
    scale = max(float(g.abs().max()) for g in gj.values())
    for k, p in tm.network.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(),
                                   atol=1e-10 * scale, err_msg=k)
    tm.float()
    kw = dict(n_samples=4, n_points=48, domain_size=n, seed=0)
    recj, rect = _RecordJ(), _Record()
    tkw = dict(max_epochs=2, optimizer="adam", learning_rate=1e-4)
    JTrainer(callbacks=[recj], **tkw).fit(
        jm, JNumpyLoader(jpar.SyntheticPointClouds(**kw), batch_size=4),
        params=jax.tree.map(jnp.asarray, params))
    tm.network.load_state_dict(params_from_jax(params))
    Trainer(callbacks=[rect], device="cpu", **tkw).fit(
        tm, NumpyLoader(tpar.SyntheticPointClouds(**kw), batch_size=4))
    assert rect.losses[1] < rect.losses[0]
    np.testing.assert_allclose(rect.losses, recj.losses, rtol=TRAJ_RTOL)


def test_unknown_network_input_or_loss_type_raises():
    with pytest.raises(ValueError, match="network_input"):
        IBNPoisson2D(None, network_input="points", domain_size=8)
    with pytest.raises(ValueError, match="ibn_loss_type"):
        IBNPoisson2D(None, ibn_loss_type="strong", domain_size=8)


def test_direct_solve_through_residual_for_field_matches_jax():
    """module_linear_solve of one cloud's immersed problem (u = 1 inside,
    0 on the walls), as the held-out geometries are scored."""
    n = 17
    cloud, forcing, sink = _cloud_batch(n, bs=1)
    chi = np.asarray(jgeo.occupancy_from_cloud(
        jnp.asarray(cloud[..., 0:2]), jnp.asarray(cloud[..., 2:4]),
        jnp.asarray(cloud[..., 4]), (n, n)))[0]
    inputs = np.stack([np.ones((n, n)), chi, sink[0, ..., 0]],
                      -1).astype(np.float32)
    uj, _ = jsolve(JIBNPoisson2D(None, domain_size=n),
                   inputs_tensor=inputs, forcing_tensor=forcing[0])
    ut, info = module_linear_solve(IBNPoisson2D(None, domain_size=n),
                                   inputs_tensor=inputs,
                                   forcing_tensor=forcing[0], device="cpu")
    uj = np.asarray(uj)
    np.testing.assert_allclose(ut, uj, atol=1e-5)
    assert np.all(ut[chi > 0.5] == 1.0) and 0.1 < ut.mean() < 0.9


# -- trainer ----------------------------------------------------------------

class _RecordJ(JCallback):
    def __init__(self):
        self.losses = []

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])


class _Record(Callback):
    def __init__(self):
        self.losses, self.lrs = [], []

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])
        self.lrs.append(state.optimizer.param_groups[0]["lr"])


def test_lr_milestones_follow_optax_piecewise_constant():
    """After each epoch the learning rate is optax's piecewise-constant
    schedule at the next step, with the milestones in epochs times the
    steps an epoch (3 here)."""
    n = 8
    ds = tpar.SyntheticPointClouds(n_samples=6, n_points=16, domain_size=n)
    tm = IBNPoisson2D(AE(1, 1, dims=1, n_downsample=1), domain_size=n)
    rec = _Record()
    Trainer(max_epochs=6, optimizer="sgd", learning_rate=0.3,
            lr_milestones=(2, 3, 5), lr_gamma=0.5, callbacks=[rec],
            device="cpu").fit(tm, NumpyLoader(ds, batch_size=2))
    sched = optax.piecewise_constant_schedule(
        0.3, {m * 3: 0.5 for m in (2, 3, 5)})
    want = [float(sched((e + 1) * 3)) for e in range(6)]
    np.testing.assert_allclose(rec.lrs, want, rtol=1e-6)
    assert rec.lrs[-1] == pytest.approx(0.3 * 0.5**3)
    with pytest.raises(ValueError, match="lbfgs"):
        Trainer(optimizer="lbfgs", lr_milestones=(1,), device="cpu")


def test_five_adam_steps_match_jax_loss_for_loss():
    """The slice: clouds -> winding chi -> AE -> gpw energy, 5 Adam steps
    with a milestone after the second, from the same weights and on the
    same shuffled batches; loss for loss."""
    n = 16
    kw = dict(n_samples=4, n_points=48, domain_size=n, seed=0)
    jds, tds = jpar.SyntheticPointClouds(**kw), tpar.SyntheticPointClouds(**kw)
    jnet, tnet, params = _net_pair("ae", n, _cloud_batch(n))
    jm = JIBNPoisson2D(jnet, domain_size=n)
    tm = IBNPoisson2D(tnet, domain_size=n)
    recj, rect = _RecordJ(), _Record()
    tkw = dict(max_epochs=5, optimizer="adam", learning_rate=3e-3,
               lr_milestones=(2,))
    JTrainer(callbacks=[recj], **tkw).fit(
        jm, JNumpyLoader(jds, batch_size=4, shuffle=True),
        params=jax.tree.map(jnp.asarray, params))
    Trainer(callbacks=[rect], device="cpu", **tkw).fit(
        tm, NumpyLoader(tds, batch_size=4, shuffle=True))
    assert rect.losses[-1] < 0.7 * rect.losses[0]
    np.testing.assert_allclose(rect.losses, recj.losses, rtol=TRAJ_RTOL)


def test_make_run_dir_takes_the_next_version(tmp_path):
    assert make_run_dir(str(tmp_path), "ibn").endswith("ibn/version_0")
    assert make_run_dir(str(tmp_path), "ibn").endswith("ibn/version_1")


# -- query and export -------------------------------------------------------

def test_query_batched_matches_jax(tmp_path):
    n = 16
    ds = tpar.SyntheticPointClouds(n_samples=5, n_points=40, domain_size=n)
    jnet, tnet, params = _net_pair("ae", n, _cloud_batch(n))
    jm = JIBNPoisson2D(jnet, domain_size=n)
    tm = IBNPoisson2D(tnet, domain_size=n)
    uj = jquery_batched(jm, jax.tree.map(jnp.asarray, params), ds,
                        batch_size=2)
    ut = query_batched(tm, ds, batch_size=2, device="cpu")
    assert ut.shape == (5, n, n)
    np.testing.assert_allclose(ut, uj, atol=LOSS_RTOL * np.abs(uj).max())
    mean, sdev, all_u = query_statistical(tm, ds, batch_size=2,
                                          out_dir=str(tmp_path),
                                          device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "q_mean.npy"), mean)
    np.testing.assert_array_equal(all_u.std(axis=0), sdev)


def test_export_round_trip_equals_the_forward(tmp_path):
    net = AE(1, 1, dims=2, n_downsample=2)
    x = torch.rand(3, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    path = save_exported(export_forward(net, x), str(tmp_path / "ae.pt2"))
    loaded = load_exported(path).module()
    with torch.no_grad():
        assert torch.equal(loaded(x), net(x))
        x2 = torch.rand(3, 16, 16, 1)
        assert torch.equal(loaded(x2), net(x2))
    assert math.isfinite(float(loaded(x).sum()))
