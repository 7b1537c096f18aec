"""The port's 3D IBN path and the geometry inputs of the IBN family against
the JAX package's, on the same numpy inputs: the geometry datasets
(``TopoDataset3D``, ``synthesize_topology_3d``, ``image_to_point_cloud``,
``PCVox``, ``nurbs_curve``, ``ParametricNURBS``), ``surface_nets`` and the
OBJ export, ``IBNPoisson3D``'s loss and training loss with a ``UNet3D``, a
3-step Adam trajectory, and the held-out direct solve of a topology.

Tolerances: datasets and meshes equal (the same numpy code); the loss
within 1e-5 relative and its field gradient within 1e-5 of its largest
entry. Through a UNet3D the loss and the parameter gradients (of the
largest entry) agree within 1e-4 in float32 and 1e-10 in float64: the
energy takes differences of the network's nearly flat sigmoid output, so
float32 rounding grows (JAX's float32 loss is 2e-5 off the float64 value,
the port's 2e-8), and the U-Net's bottom stages normalise over 2^3 and 1^3
maps. The 3-step trajectory within 1e-4 relative. The direct solve within
1e-4: both run CG at tol 1e-6 in float32 (slice I's: float32 CG stalls
above 1e-7) and land within 3.5e-5 of the float64 solution (true relative
residuals ~2e-5, the float32 floor).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.data import NumpyLoader as JNumpyLoader
from diffnet_tpu.data import geometry_datasets as jgd
from diffnet_tpu.models.networks import UNet3D as JUNet3D
from diffnet_tpu.pde.ibn import IBNPoisson3D as JIBNPoisson3D
from diffnet_tpu.pde.poisson import Poisson3D as JPoisson3D
from diffnet_tpu.train.linear import module_linear_solve as jsolve
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu.utils import mesh3d as jmesh
from diffnet_tpu_torch.data import NumpyLoader
from diffnet_tpu_torch.data import geometry_datasets as tgd
from diffnet_tpu_torch.interop import (flax_shapes, params_from_jax,
                                       seeded_params)
from diffnet_tpu_torch.models import UNet3D
from diffnet_tpu_torch.pde import IBNPoisson3D, Poisson3D
from diffnet_tpu_torch.train import Trainer, module_linear_solve
from diffnet_tpu_torch.utils import mesh3d as tmesh

from .test_torch_ibn import _Record, _RecordJ
from .test_torch_networks import flax_params, shape_tree

LOSS_RTOL = 1e-5
NET_RTOL = {np.float32: 1e-4, np.float64: 1e-10}
TRAJ_RTOL = 1e-4
SOLVE_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(a, b):
    """Nested tuples or lists of arrays equal in type and value."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


# -- datasets ---------------------------------------------------------------

def test_synthesize_topology_3d_and_dataset_match_jax(tmp_path):
    vols = [jgd.synthesize_topology_3d(n=16, n_bars=4, seed=s)
            for s in range(3)]
    _equal(vols, [tgd.synthesize_topology_3d(n=16, n_bars=4, seed=s)
                  for s in range(3)])
    assert 0 < vols[0].mean() < 0.5
    jds, tds = jgd.TopoDataset3D(vols, 16), tgd.TopoDataset3D(vols, 16)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        _equal(tds[i], jds[i])
    assert tds[0][0].shape == (16, 16, 16, 3)
    # a directory of npz files, under 'chi' or the first array
    np.savez(tmp_path / "a.npz", chi=vols[0])
    np.savez(tmp_path / "b.npz", vols[1])
    for i in range(2):
        _equal(tgd.TopoDataset3D(str(tmp_path), 16)[i],
               jgd.TopoDataset3D(str(tmp_path), 16)[i])
    with pytest.raises(ValueError, match="domain_size"):
        tgd.TopoDataset3D(vols, 17)


def _disk_image(ny=30, nx=40):
    yy, xx = np.mgrid[:ny, :nx]
    return (((xx - 21) / 12.0) ** 2 + ((yy - 14) / 9.0) ** 2 < 1).astype(
        float)


@pytest.mark.parametrize("n_points", [None, 25])
def test_image_to_point_cloud_matches_jax(n_points):
    img = _disk_image()
    _equal(tgd.image_to_point_cloud(img, n_points),
           jgd.image_to_point_cloud(img, n_points))


def test_pcvox_from_array_and_file_matches_jax(tmp_path):
    import PIL.Image

    img = _disk_image()
    path = tmp_path / "disk.png"
    PIL.Image.fromarray((img * 255).astype(np.uint8)).save(path)
    for src in (img, str(path)):
        jd, td = jgd.PCVox(src, domain_size=24), tgd.PCVox(src, domain_size=24)
        _equal(td.cloud, jd.cloud)
        assert len(td) == len(jd)
        _equal(td[3], jd[3])


@pytest.mark.parametrize("closed", [True, False])
def test_nurbs_curve_matches_jax(closed):
    ctrl = 0.5 + 0.3 * np.stack([np.cos(np.arange(7)), np.sin(2.0 *
                                 np.arange(7))], -1)
    w = np.linspace(0.5, 2.0, 7)
    _equal(tgd.nurbs_curve(ctrl, w, n_samples=60, closed=closed),
           jgd.nurbs_curve(ctrl, w, n_samples=60, closed=closed))
    with pytest.raises(ValueError, match="weights"):
        tgd.nurbs_curve(ctrl, w[:3])


def test_parametric_nurbs_matches_jax():
    kw = dict(n_samples=3, n_control=6, n_points=50, domain_size=16, seed=2)
    jd, td = jgd.ParametricNURBS(**kw), tgd.ParametricNURBS(**kw)
    assert len(td) == len(jd) == 3
    for i in range(3):
        _equal(td[i], jd[i])


# -- surface nets -----------------------------------------------------------

def test_surface_nets_and_obj_match_jax(tmp_path):
    """A sphere SDF clipped by the grid (capped by close_boundary) and one
    inside it: the same vertices and quads, and the same OBJ text."""
    g = np.linspace(-1, 1, 20)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    for c, r in (((0.0, 0.1, -0.2), 0.6), ((0.5, 0.5, 0.5), 0.9)):
        sdf = np.sqrt((xx - c[2]) ** 2 + (yy - c[1]) ** 2
                      + (zz - c[0]) ** 2) - r
        vt, qt = tmesh.surface_nets(sdf, level=0.0, spacing=(0.1, 0.2, 0.3))
        vj, qj = jmesh.surface_nets(sdf, level=0.0, spacing=(0.1, 0.2, 0.3))
        _equal((vt, qt), (vj, qj))
        assert len(qt) > 100
    tmesh.field_to_obj(tmp_path / "t.obj", sdf, level=0.0)
    jmesh.field_to_obj(tmp_path / "j.obj", sdf, level=0.0)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    assert tmesh.surface_nets(np.ones((4, 4, 4)), close_boundary=False)[
        1].shape == (0, 4)


# -- IBNPoisson3D -----------------------------------------------------------

def _topo_batch(n=32, bs=2, seed=0):
    ds = tgd.TopoDataset3D([tgd.synthesize_topology_3d(n=n, seed=seed + i)
                            for i in range(bs)], domain_size=n)
    return tuple(np.stack([ds[i][k] for i in range(bs)]) for k in range(2))


def test_loss_and_apply_bcs_match_jax():
    """The gpw energy (with a nonzero forcing, as the module allows) and
    its field gradient, and apply_bcs, at 32^3."""
    n = 32
    inputs, _ = _topo_batch(n)
    rng = np.random.default_rng(0)
    inputs[..., 0] = 0.5 + rng.random(inputs.shape[:-1])
    u = rng.random(inputs.shape[:-1] + (1,)).astype(np.float32)
    forcing = rng.random(u.shape).astype(np.float32)
    jm, tm = JIBNPoisson3D(None, domain_size=n), IBNPoisson3D(None,
                                                               domain_size=n)
    lj, gj = jax.value_and_grad(lambda v: jm.loss(
        v, jnp.asarray(inputs), jnp.asarray(forcing)))(jnp.asarray(u))
    tu = _t(u).requires_grad_()
    lt = tm.loss(tu, _t(inputs), _t(forcing))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    gj = np.asarray(gj)
    np.testing.assert_allclose(tu.grad.numpy(), gj,
                               atol=LOSS_RTOL * np.abs(gj).max())
    bj = np.asarray(jm.apply_bcs(jnp.asarray(u), jnp.asarray(inputs)))
    bt = tm.apply_bcs(_t(u), _t(inputs)).numpy()
    np.testing.assert_array_equal(bt, bj)
    assert (bt[inputs[..., 1] > 0.5] == 1).all()
    assert (bt[(inputs[..., 2] > 0.5) & (inputs[..., 1] < 0.5)] == 0).all()


def _unet_pair(n, batch):
    jnet = JUNet3D(out_channels=1, base_filters=2)
    tnet = UNet3D(3, 1, base_filters=2)
    params = jax.tree.map(np.asarray, flax_params(jnet, batch[0]))
    tnet.load_state_dict(params_from_jax(params))
    return jnet, tnet, params


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_training_loss_with_unet3d_matches_jax(dtype):
    """training_loss of a UNet3D (all three input channels in) at 32^3,
    and its parameter gradients, with the flax weights carried across."""
    n = 32
    batch = _topo_batch(n)
    jnet, tnet, params = _unet_pair(n, batch)
    batch = tuple(b.astype(dtype) for b in batch)
    tm = IBNPoisson3D(tnet, domain_size=n).to(
        torch.float64 if dtype == np.float64 else torch.float32)
    with jax.enable_x64(dtype == np.float64):
        lj, gj = jax.jit(jax.value_and_grad(
            JIBNPoisson3D(jnet, domain_size=n).training_loss))(
                jax.tree.map(lambda a: jnp.asarray(a, dtype), params),
                tuple(map(jnp.asarray, batch)))
        lj, gj = float(lj), jax.tree.map(np.asarray, gj)
    lt = tm.training_loss(tuple(map(_t, batch)))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), lj, rtol=NET_RTOL[dtype])
    gj = params_from_jax(gj)
    scale = max(float(g.abs().max()) for g in gj.values())
    for k, p in tm.network.named_parameters():
        assert p.grad.dtype == gj[k].dtype
        np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(),
                                   atol=NET_RTOL[dtype] * scale, err_msg=k)


def test_three_adam_steps_match_jax_loss_for_loss():
    """Three epochs of one batch of two topologies, Adam 1e-3 (the
    examples/ibn_3d.py rate), from the same weights: loss for loss."""
    n = 32
    vols = [tgd.synthesize_topology_3d(n=n, seed=s) for s in range(2)]
    jds, tds = jgd.TopoDataset3D(vols, n), tgd.TopoDataset3D(vols, n)
    jnet, tnet, params = _unet_pair(n, _topo_batch(n))
    jm, tm = JIBNPoisson3D(jnet, domain_size=n), IBNPoisson3D(tnet,
                                                               domain_size=n)
    recj, rect = _RecordJ(), _Record()
    tkw = dict(max_epochs=3, optimizer="adam", learning_rate=1e-3)
    JTrainer(callbacks=[recj], **tkw).fit(
        jm, JNumpyLoader(jds, batch_size=2),
        params=jax.tree.map(jnp.asarray, params))
    Trainer(callbacks=[rect], device="cpu", **tkw).fit(
        tm, NumpyLoader(tds, batch_size=2))
    assert rect.losses[-1] < rect.losses[0]
    np.testing.assert_allclose(rect.losses, recj.losses, rtol=TRAJ_RTOL)


def test_heldout_direct_solve_through_poisson3d_matches_jax():
    """A topology's held-out reference: CG on Poisson3D's resmin residual
    (u = 1 on chi, 0 on the box) over the dataset's (domain, chi, bc2)
    inputs; the port through K5's operator (its plain version on the CPU),
    the JAX package through its XLA operator, at 17^3."""
    n = 17
    inputs, forcing = tgd.TopoDataset3D(
        [tgd.synthesize_topology_3d(n=n, seed=4)], n)[0]
    uj, _ = jsolve(JPoisson3D(domain_size=n, loss_type="resmin"),
                   inputs_tensor=inputs, forcing_tensor=forcing, tol=1e-6)
    tm = Poisson3D(domain_size=n, loss_type="resmin", fused_kernels=True,
                   bc1_value=1.0, bc2_value=0.0)
    ut, _ = module_linear_solve(tm, inputs_tensor=inputs,
                                forcing_tensor=forcing, tol=1e-6,
                                device="cpu")
    np.testing.assert_allclose(ut, np.asarray(uj), atol=SOLVE_ATOL)
    chi = inputs[..., 1] > 0.5
    wall = (inputs[..., 2] > 0.5) & ~chi
    assert chi.any() and (ut[chi] == 1).all() and (ut[wall] == 0).all()
    free = ~chi & (inputs[..., 2] < 0.5)
    assert 0 < ut[free].min() and ut[free].max() < 1


def test_reference_script_draws_the_ports_initial_weights():
    """scripts/torch_port_reference_ibn3d.py starts the JAX package's
    UNet3D from its own copy of seeded_params over the flax tree's shapes;
    chip_smoke.py's slice I starts the port's from interop.seeded_params
    over flax_shapes. The two trees are equal leaf for leaf, so both
    packages train the same network."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference_ibn3d", os.path.join(
            os.path.dirname(__file__), "..", "scripts",
            "torch_port_reference_ibn3d.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    n = 32
    jnet, tnet = JUNet3D(out_channels=1, base_filters=2), UNet3D(
        3, 1, base_filters=2)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0),
                            jnp.zeros((1, n, n, n, 3), jnp.float32))
    jtree = ref.seeded_params(ref.shape_tree(shapes["params"]),
                              ref.INIT_SEED)
    ttree = seeded_params(flax_shapes(tnet), ref.INIT_SEED)
    assert shape_tree(jtree) == shape_tree(ttree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                            jax.tree.leaves(ttree)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=str(path))
