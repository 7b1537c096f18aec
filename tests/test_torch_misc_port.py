"""The port's last pieces against the JAX package's, on the same seeded numpy
inputs: ``core/fem.py::element_matvec`` and ``gp_eval_1d`` with the FEM
modules' ``gauss_pt_evaluation_surf``, the six immersed single-instance
datasets and their energies through K3's plain version, the GAN zoo
(``models/gan.py``) from carried flax weights, the xyzna reader and writer,
and the matplotlib plots (``utils/viz.py``).

Tolerances: the FEM contractions in float32 (JAX's accumulate in float32
whatever their input) within 1e-6 of the largest |JAX value|; the networks
in float64 (JAX under ``enable_x64``) within 1e-10 of it (the same sums in
another order); datasets bit-equal (the same numpy code); the
float32 energies within 1e-5 relative and their gradients within 1e-5 of
the largest entry (rounding); xyzna arrays within 1e-18 (18 printed
decimals).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.core import fem as jfem
from diffnet_tpu.core.quadrature import make_basis
from diffnet_tpu.data import single_instances as jsi
from diffnet_tpu.models import gan as jgan
from diffnet_tpu.pde import Poisson2D as JPoisson2D
from diffnet_tpu.pde.base import FEM2DModule as JFEM2DModule
from diffnet_tpu.utils import xyzna as jxyzna
from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.data import single_instances as tsi
from diffnet_tpu_torch.interop import (flax_shapes, params_from_jax,
                                       seeded_params)
from diffnet_tpu_torch.models import (DirectField, Discriminator,
                                      FCGenerator, LatentGenerator,
                                      ResidualFCGenerator)
from diffnet_tpu_torch.pde import FEM2DModule, Poisson2D
from diffnet_tpu_torch.train import Trainer
from diffnet_tpu_torch.utils import (ContourPlotCallback, plot_contours,
                                     plot_line_cuts, plot_losses,
                                     plot_point_histograms, read_xyzna,
                                     write_xyzna)

FEM_TOL = 1e-6
NET_TOL = 1e-10
F32_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- core/fem.py --------------------------------------------------------------

@pytest.mark.parametrize("nsd,deg,shape", [(2, 1, (2, 7, 9)),
                                           (2, 2, (9, 7)),
                                           (3, 1, (5, 4, 6))])
def test_element_matvec(nsd, deg, shape):
    rng = np.random.default_rng(nsd * 10 + deg)
    nbf = (deg + 1) ** nsd
    K = rng.standard_normal((nbf, nbf))
    u = rng.standard_normal(shape).astype(np.float32)
    node_shape = shape[-nsd:]
    ref = np.asarray(jfem.element_matvec(jnp.asarray(u), K, deg, nsd,
                                         node_shape))
    got = fem.element_matvec(torch.from_numpy(u), K, deg, nsd,
                             node_shape).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=FEM_TOL * np.abs(ref).max())


@pytest.mark.parametrize("nsd,deg", [(2, 1), (2, 2), (3, 1)])
def test_gp_eval_1d_and_surface_evaluation(nsd, deg):
    n = 9
    h = tuple(0.7 / (n - 1) * (k + 1) for k in range(nsd))
    quants = ("N", "dx", "dy") + (("dz",) if nsd == 3 else ())
    jb = make_basis(nsd, deg, h=h)
    tb = fem.BasisTables(jb)
    line = np.random.default_rng(deg).standard_normal((3, n)).astype(
        np.float32)
    ref = jfem.gp_eval_1d(jnp.asarray(line), jb, quants)
    ref = {q: np.asarray(v) for q, v in ref.items()}
    got = fem.gp_eval_1d(torch.from_numpy(line), tb, quants)
    assert set(got) == set(ref)
    for q in quants:
        assert got[q].shape == ref[q].shape == (3, (n - 1) // deg,
                                                jb.ngp_1d)
        np.testing.assert_allclose(got[q].numpy(), ref[q], rtol=0,
                                   atol=FEM_TOL * np.abs(ref[q]).max())
    if nsd == 2:
        jm = JFEM2DModule(None, None, domain_size=n, fem_basis_deg=deg)
        tm = FEM2DModule(None, None, domain_size=n, fem_basis_deg=deg)
        jr = jm.gauss_pt_evaluation_surf(jnp.asarray(line), ("N", "dx"))
        jr = {q: np.asarray(v) for q, v in jr.items()}
        tr = tm.gauss_pt_evaluation_surf(torch.from_numpy(line),
                                         ("N", "dx"))
        for q in ("N", "dx"):
            np.testing.assert_allclose(tr[q].numpy(), jr[q], rtol=0,
                                       atol=FEM_TOL * np.abs(jr[q]).max())
        assert tm.gauss_pt_evaluation_surf(torch.from_numpy(line))[
            "N"].shape == jr["N"].shape


# -- the immersed single instances --------------------------------------------

IMMERSED = ["RectangleIM", "RectangleIMBack", "CircleIMBack", "LShaped"]


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    """A grey-scale PNG of a disk beside a bar, written with PIL."""
    import PIL.Image

    yy, xx = np.mgrid[0:48, 0:48]
    img = ((xx - 20) ** 2 + (yy - 22) ** 2 < 81) | ((xx > 35) & (yy < 8))
    path = str(tmp_path_factory.mktemp("img") / "object.png")
    PIL.Image.fromarray((img * 200).astype(np.uint8)).save(path)
    return path


def _datasets(name, image_file):
    if name in ("ImageIMBack", "Disk"):
        return (getattr(jsi, name)(image_file, domain_size=17),
                getattr(tsi, name)(image_file, domain_size=17))
    return getattr(jsi, name)(), getattr(tsi, name)()


@pytest.mark.parametrize("name", IMMERSED + ["ImageIMBack", "Disk"])
def test_immersed_datasets_are_bit_equal(name, image_file):
    j, t = _datasets(name, image_file)
    arrays = {k for k, v in vars(j).items() if isinstance(v, np.ndarray)}
    assert arrays == {k for k, v in vars(t).items()
                      if isinstance(v, np.ndarray)}
    for k in arrays:
        assert getattr(t, k).dtype == getattr(j, k).dtype, k
        assert np.array_equal(getattr(t, k), getattr(j, k)), k
    for a, b in zip(t[0], j[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(t) == len(j)


def test_load_binary_image_rejects_other_extensions(tmp_path):
    with pytest.raises(ValueError, match="extension"):
        tsi._load_binary_image(str(tmp_path / "object.gif"))


@pytest.mark.parametrize("name", IMMERSED + ["Disk"])
def test_immersed_energy_through_k3_matches_jax(name, image_file):
    """The slice: Poisson2D's energy of each immersed instance, through
    K3's plain version (``fused_kernels=True``), and its field gradient
    against the JAX package's energy in float32."""
    j, t = _datasets(name, image_file)
    inputs, forcing = t[0]
    n = inputs.shape[0]
    u = np.random.default_rng(7).standard_normal((1, n, n)).astype(
        np.float32)
    jm = JPoisson2D(None, j, domain_size=n, batch_size=1)
    jl, jg = jax.jit(jax.value_and_grad(lambda a: jm.loss(
        a, jnp.asarray(inputs)[None], jnp.asarray(forcing)[None])))(
            jnp.asarray(u))
    tm = Poisson2D(None, t, domain_size=n, batch_size=1, fused_kernels=True)
    tu = torch.tensor(u, requires_grad=True)
    tl = tm.loss(tu, torch.from_numpy(inputs)[None],
                 torch.from_numpy(forcing)[None])
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= F32_RTOL * abs(float(jl))
    jg = np.asarray(jg)
    np.testing.assert_allclose(tu.grad.numpy(), jg, rtol=0,
                               atol=F32_RTOL * np.abs(jg).max())


# -- models/gan.py ------------------------------------------------------------

def _carried(jnet, tnet, x):
    """Run both networks from one flax tree: drawn with numpy by flax's
    initializers on the port's shapes (``interop.seeded_params``; JAX's own
    init would compile for seconds), then jittered by a seeded draw so that
    no bias or scale sits at its initial value."""
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape),
        seeded_params(flax_shapes(tnet), 0))
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(jnet.apply)(
            {"params": jax.tree_util.tree_map(jnp.asarray, tree)},
            jnp.asarray(x)))
    tnet = tnet.double()
    tnet.load_state_dict(params_from_jax(tree), strict=True)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("which", ["fc", "residual_fc", "latent",
                                   "discriminator"])
def test_gan_zoo_matches_flax(which):
    """The JAX package's test sizes (tests/test_pointnets_gan.py)."""
    z = np.random.default_rng(1).standard_normal((2, 128))
    img = np.random.default_rng(2).random((2, 32, 32, 1))
    jnet, tnet, x = {
        "fc": (jgan.FCGenerator(output_dim=256), FCGenerator(128, 256), z),
        "residual_fc": (jgan.ResidualFCGenerator(output_dim=256),
                        ResidualFCGenerator(128, 256), z),
        "latent": (jgan.LatentGenerator(out_size=32, dim=8),
                   LatentGenerator(128, out_size=32, dim=8), z),
        "discriminator": (jgan.Discriminator(dim=8),
                          Discriminator((32, 32), dim=8), img)}[which]
    got, ref = _carried(jnet, tnet, x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=NET_TOL * max(1.0, np.abs(ref).max()))
    if which == "discriminator":   # [B, H, W] inputs take one channel
        with torch.no_grad():
            np.testing.assert_array_equal(
                tnet(torch.from_numpy(x[..., 0])).numpy(), got)


def test_latent_generator_sizes():
    for size in (4, 8, 64):
        net = LatentGenerator(16, out_size=size, dim=2)
        assert net(torch.zeros(3, 16)).shape == (3, size, size, 1)
    with pytest.raises(ValueError, match="power of two"):
        LatentGenerator(16, out_size=48)


# -- utils/xyzna.py -----------------------------------------------------------

def test_xyzna_round_trip_and_both_readers(tmp_path):
    rng = np.random.default_rng(4)
    pts, nrm, area = rng.random((25, 3)), rng.standard_normal((25, 3)), \
        rng.random(25)
    ours, theirs = str(tmp_path / "port.xyzna"), str(tmp_path / "jax.xyzna")
    write_xyzna(ours, pts, nrm, area)
    jxyzna.write_xyzna(theirs, pts, nrm, area)
    assert open(ours).read() == open(theirs).read()
    for got in (read_xyzna(ours), jxyzna.read_xyzna(ours),
                read_xyzna(theirs)):
        for a, b in zip(got, (pts, nrm, area)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-18)
    # the flat layout, and no areas given
    flat = str(tmp_path / "flat.xyzna")
    np.savetxt(flat, np.concatenate([pts, nrm], 1))
    for a, b in zip(read_xyzna(flat), jxyzna.read_xyzna(flat)):
        np.testing.assert_array_equal(a, b)
    write_xyzna(ours, pts, nrm)
    assert np.array_equal(read_xyzna(ours)[2], np.zeros(25))
    # a short areas block raises, as JAX's reader does
    lines = open(theirs).read().splitlines()[:-3]
    open(ours, "w").write("\n".join(lines) + "\n")
    for reader in (read_xyzna, jxyzna.read_xyzna):
        with pytest.raises(ValueError, match="truncated"):
            reader(ours)


# -- utils/viz.py -------------------------------------------------------------

def test_plots_write_their_files(tmp_path):
    rng = np.random.default_rng(5)
    u = rng.random((12, 10))
    out = str(tmp_path / "a" / "contours.png")
    assert plot_contours(out, {"u": u, "t": torch.from_numpy(u)},
                         ncols=1, suptitle="s") == out
    out2 = str(tmp_path / "cuts.png")
    assert plot_line_cuts(out2, torch.from_numpy(u), u_exact=u) == out2
    out3 = str(tmp_path / "hist.png")
    assert plot_point_histograms(out3, {(1, 2): rng.random(50),
                                        (3, 4): rng.random(50)}) == out3
    for path in (out, out2, out3):
        assert os.path.getsize(path) > 1000


def test_contour_callback_and_loss_plot_under_the_trainer(tmp_path):
    n = 9
    ds = tsi.Rectangle(domain_size=n)
    ds.n_samples = 1
    m = Poisson2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                  domain_size=n, batch_size=1)
    run = str(tmp_path / "run")
    os.makedirs(run)
    Trainer(max_epochs=4, optimizer="adam", learning_rate=1e-2,
            run_dir=run, callbacks=[ContourPlotCallback(every=2,
                                                        out_dir=run)],
            device="cpu").fit(m)
    assert sorted(f for f in os.listdir(run) if f.startswith("contour")) \
        == ["contour_0.png", "contour_2.png"]
    path = plot_losses(run)
    assert path == os.path.join(run, "losses.png") and os.path.getsize(
        path) > 1000


def test_importing_the_port_needs_no_matplotlib_nor_pil():
    code = ("import sys, diffnet_tpu_torch, diffnet_tpu_torch.core, "
            "diffnet_tpu_torch.data, diffnet_tpu_torch.models, "
            "diffnet_tpu_torch.pde, diffnet_tpu_torch.train, "
            "diffnet_tpu_torch.utils\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'PIL', 'jax', 'diffnet_tpu')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
