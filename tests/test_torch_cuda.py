"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than torch. Fields at atol
2e-6 times max(1, max |ref|) (O(1) float32 stencils), scalars at rtol 1e-5,
the K2 gradient at 1e-5 of its largest entry, the VJPs as the fields; the
MG-CG solution through K4 within the plain solve's (14 float32 CG
iterations, each matvec summed in another order) at 1e-3 of its largest
entry, both at a relative residual below 1e-4; the 17^3 3D MMS fit through
K5 within 1.3x the JAX package's final rel L2; bf16 K1 and K3 at 8e-3
times max(1, max |ref|) of their bf16 plain versions (each rounds once from
float32); K6's residuals at 2e-5 times
max(1, max |ref|) (the JAX package's kernel-vs-XLA tolerance), its VJP and
JVP as the other VJPs; the 33^2 Newton solve through K6 at |F| < 1e-6 and
within 1e-4 of the plain solve; the IBN slices' losses and gradients (no
kernel of ours: the winding number, cuDNN convolutions and the energy; the
3D one in float32 and float64) at 1e-5 of the CPU's (1e-10 in float64),
and DGCNN2D's forward at 1e-5 of the CPU's; the spatially sharded K1
and K5 (slice N1 and N2: 4 ranks sharing the card over gloo) and their
VJPs through the halo exchange at 2e-6 times max(1, max |ref|) of the
unsharded kernels'; slice J's energy step through
K3 and K1 (with and without remat) at 1e-5 of the plain loss and 1e-4 of
its largest parameter gradient; slice K's objectives through K6 at 1e-5 of
the plain loss and 2e-5 of the largest field gradient; slice L's eikonal
and SUPG losses (no kernel of ours) at 1e-5 of the CPU's loss and largest
field gradient, and a float64 Gauss-Newton step's losses at 1e-12 of the
first and its field at 1e-6 of its largest value; slice M's topology
optimisation through K1 against the CPU route, its first compliance at
1e-5 and its second at 1e-4 relative, and its immersed energies through
K3 and K1 at 1e-5 of the plain loss and of the largest field gradient;
the CUDA-graph replays of the V-cycle (at the fields' tolerance) and of
GMRES on the NS Jacobian (at its tol, 1e-4 of max |dx|) against their
eager runs, each with the eager run's kernel counts.
"""

import numpy as np
import pytest
import torch

from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.data import (CuboidManufactured, NSLDCDataset,
                                    RectangleManufactured)
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.ops import ns_residual as k6
from diffnet_tpu_torch.ops import poisson_energy as k3
from diffnet_tpu_torch.ops import poisson_loss_grad as k2
from diffnet_tpu_torch.ops import poisson_residual as k1
from diffnet_tpu_torch.ops import poisson_residual_3d as k5
from diffnet_tpu_torch.ops import stencil_apply as k4
from diffnet_tpu_torch.pde import NavierStokes, Poisson2D, Poisson3D, ldc_bcs
from diffnet_tpu_torch.train import (Trainer, cg, multigrid_preconditioner,
                                     ns_newton_solve)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fields(shape, dev, n=4, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.rand(shape, generator=g).to(dev) for _ in range(n)]


def _basis(ny, nx, dev, aniso=False):
    h = ((0.7 / (nx - 1), 1.9 / (ny - 1)) if aniso
         else (1 / (nx - 1), 1 / (ny - 1)))
    return fem.BasisTables(make_basis(2, 1, h=h)).to(dev)


def _field_close(a, b):
    torch.testing.assert_close(a, b, rtol=0,
                               atol=2e-6 * max(1.0, float(b.abs().max())))


# 1 x 2^2, 3 x 129 x 257, 1 x 513^2, 1 x 100 x 77 and 1 x 40 x 65 (widths
# that are no multiple of K1's and K3's 64 columns or K2's 61) hit the tile
# edges
SHAPES = [((2, 33, 33), True), ((2, 40, 40), False), ((2, 24, 49), False),
          ((3, 129, 257), False), ((1, 2, 2), False), ((1, 513, 513), False),
          ((1, 100, 77), False), ((1, 40, 65), False)]


@pytest.mark.parametrize("shape,aniso", SHAPES)
def test_stiffness_kernel_matches_plain(dev, shape, aniso):
    tb = _basis(*shape[1:], dev, aniso)
    u, nu, _, _ = _fields(shape, dev)
    before = k1.launches
    K = k1.stiffness_action(u, nu, tb)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    _field_close(K, k1.stiffness_action_plain(u, nu, tb))


def _k2_inputs(shape, dev, plane):
    u, nu, Nf, bc = _fields(shape, dev)
    bc = (bc > 0.7).float()
    if plane:   # Nf and bc shared by the batch
        Nf, bc = Nf[0].contiguous(), bc[0].contiguous()
    return u, nu, Nf, bc


def _k2_close(out, ref):
    (loss, grad), (loss_p, grad_p) = out, ref
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, grad_p, rtol=0,
                               atol=1e-5 * float(grad_p.abs().max()))


@pytest.mark.parametrize("shape,aniso,plane", [
    ((2, 33, 33), True, True), ((2, 40, 40), False, False),
    ((2, 24, 49), False, True), ((3, 129, 257), False, False),
    ((3, 129, 257), False, True), ((1, 40, 65), False, False),
    ((1, 100, 77), False, True), ((1, 2, 2), False, False),
    ((1, 513, 513), False, True), ((1, 513, 513), False, False)])
def test_loss_grad_kernel_matches_plain(dev, shape, aniso, plane):
    tb = _basis(*shape[1:], dev, aniso)
    u, nu, Nf, bc = _k2_inputs(shape, dev, plane)
    before = k2.launches
    out = k2.resmin_loss_grad(u, nu, Nf, bc, tb)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    _k2_close(out, k2.resmin_loss_grad_plain(u, nu, Nf, bc, tb))


@pytest.mark.parametrize("shape", [(1, 513, 513), (32, 512, 512)])
@pytest.mark.parametrize("plane", [False, True])
def test_loss_grad_kernel_every_strip(dev, shape, plane):
    tb = _basis(*shape[1:], dev)
    u, nu, Nf, bc = _k2_inputs(shape, dev, plane)
    ref = k2.resmin_loss_grad_plain(u, nu, Nf, bc, tb)
    for ty in k2.STRIPS:
        _k2_close(k2.loss_grad_at_strip(u, nu, Nf, bc, tb, ty), ref)


@pytest.mark.parametrize("shape", [(1, 513, 513), (32, 512, 512)])
def test_energy_kernel_every_strip_both_types(dev, shape):
    tb = _basis(*shape[1:], dev)
    u, nu, f, _ = _fields(shape, dev)
    ref = k3.energy_plain(u, nu, f, tb)
    bf = [x.bfloat16() for x in (u, nu, f)]
    ref_bf = k3.energy_plain(*bf, tb)
    for ty in k3.STRIPS:
        torch.testing.assert_close(k3.energy_at_strip(u, nu, f, tb, ty), ref,
                                   rtol=1e-5, atol=0)
        _bf16_close(k3.energy_at_strip(*bf, tb, ty), ref_bf)


@pytest.mark.parametrize("shape,aniso", SHAPES)
def test_energy_kernel_matches_plain(dev, shape, aniso):
    tb = _basis(*shape[1:], dev, aniso)
    u, nu, f, _ = _fields(shape, dev)
    before = k3.launches
    E = k3.energy(u, nu, f, tb)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    torch.testing.assert_close(E, k3.energy_plain(u, nu, f, tb), rtol=1e-5,
                               atol=0)


def _bf16_close(a, b):
    """bf16 kernel against bf16 plain version: both round once from f32."""
    assert a.dtype == b.dtype == torch.bfloat16
    torch.testing.assert_close(a.float(), b.float(), rtol=0,
                               atol=8e-3 * max(1.0, float(b.float().abs()
                                                          .max())))


@pytest.mark.parametrize("shape,aniso", SHAPES + [((32, 512, 512), False)])
def test_bf16_stiffness_and_energy_kernels_match_plain(dev, shape, aniso):
    tb = _basis(*shape[1:], dev, aniso)
    u, nu, f, _ = (x.bfloat16() for x in _fields(shape, dev))
    before = (k1.launches, k3.launches)
    K = k1.stiffness_action(u, nu, tb)
    E = k3.energy(u, nu, f, tb)
    torch.cuda.synchronize()
    assert (k1.launches, k3.launches) == (before[0] + 1, before[1] + 1)
    _bf16_close(K, k1.stiffness_action_plain(u, nu, tb))
    _bf16_close(E, k3.energy_plain(u, nu, f, tb))


@pytest.mark.parametrize("ty", [1, 2, 3, 7, 15, 31])
def test_stiffness_kernel_every_strip(dev, ty):
    """Each tile height the kernel takes, f32 and bf16, on a grid whose
    rows and columns are no multiple of the tile."""
    from diffnet_tpu_torch.ops import _build

    lib = _build.load_library()
    shape = (2, 101, 77)
    tb = _basis(*shape[1:], dev, True)
    u, nu, _, _ = _fields(shape, dev)
    for dt in (torch.float32, torch.bfloat16):
        a, b = u.to(dt), nu.to(dt)
        out = torch.empty_like(a)
        assert lib.poisson_stiffness_action(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), *shape, ty,
            int(dt == torch.bfloat16), *k1.stiffness_consts(tb.basis),
            torch.cuda.current_stream().cuda_stream) == 0
        ref = k1.stiffness_action_plain(a, b, tb)
        if dt == torch.float32:
            _field_close(out, ref)
        else:
            _bf16_close(out, ref)


def test_misaligned_view_goes_through_the_kernel(dev):
    tb = _basis(33, 33, dev)
    big, = _fields((3 * 33 * 33 + 1,), dev, n=1)
    u = big[1:].view(3, 33, 33)     # 4 B past a 16-B boundary
    assert u.data_ptr() % 16 != 0
    before = k1.launches
    K = k1.stiffness_action(u, u, tb)
    assert k1.launches == before + 1
    _field_close(K, k1.stiffness_action_plain(u, u, tb))


def _grads(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    fn(*xs).backward()
    return [x.grad for x in xs]


def test_vjps_match_autograd_through_plain(dev):
    n = 65
    tb = _basis(n, n, dev, aniso=True)
    u, nu, f, w = _fields((2, n, n), dev)
    bc = (f[0] > 0.8).float()
    pairs = [
        (_grads(lambda u, nu: (k1.poisson_stiffness_action(u, nu, tb)
                               * w).sum(), u, nu),
         _grads(lambda u, nu: (k1.stiffness_action_plain(u, nu, tb)
                               * w).sum(), u, nu)),
        (_grads(lambda u, nu, f: k3.poisson_energy_fused(u, nu, f, tb),
                u, nu, f),
         _grads(lambda u, nu, f: k3.energy_plain(u, nu, f, tb), u, nu, f)),
        (_grads(lambda u, nu, Nf: k2.poisson_resmin_loss_fused(
            u, nu, Nf, bc, tb), u, nu, f),
         _grads(lambda u, nu, Nf: k2.resmin_loss_grad_plain(
             u, nu, Nf, bc, tb)[0], u, nu, f)),
    ]
    for got, ref in pairs:
        for a, b in zip(got, ref):
            _field_close(a, b)


@pytest.mark.parametrize("shape", [(2, 33, 33), (1, 40, 56), (3, 17, 129),
                                   (2, 129, 257), (1, 2, 2)])
@pytest.mark.parametrize("shared_c", [False, True])
def test_stencil_kernel_matches_plain(dev, shape, shared_c):
    B, ny, nx = shape
    C, = _fields((9, 1 if shared_c else B, ny, nx), dev, n=1, seed=3)
    u, = _fields(shape, dev, n=1, seed=4)
    before = k4.launches
    out = k4.apply_2d(C - 0.5, u - 0.5)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    _field_close(out, k4.stencil_apply_plain(C - 0.5, u - 0.5))


def test_stencil_vjp_matches_autograd_through_plain(dev):
    n = 65
    for cb in (2, 1):
        C, = _fields((9, cb, n, n), dev, n=1, seed=5)
        u, w = _fields((2, n, n), dev, n=2, seed=6)
        got = _grads(lambda C, u: (k4.stencil_apply(C, u) * w).sum(), C, u)
        ref = _grads(lambda C, u: (k4.stencil_apply_plain(C, u) * w).sum(),
                     C, u)
        for a, b in zip(got, ref):
            _field_close(a, b)


def test_mgcg_through_the_stencil_kernel_matches_plain(dev):
    """A 65² variable-nu MG-CG solve with every assembled level through K4
    against the same solve on the plain stencil matvec."""
    n = 65
    rng = np.random.default_rng(0)
    nu = np.exp(rng.standard_normal((n, n)) * 0.5).astype(np.float32)

    class DS:
        def __init__(self, nu):
            m = nu.shape[0]
            bc1 = np.zeros((m, m)); bc1[:, 0] = 1
            bc2 = np.zeros((m, m)); bc2[:, -1] = 1
            self.inputs = np.stack([nu, bc1, bc2], -1).astype(np.float32)
            self.forcing = np.zeros((m, m, 1), np.float32)

        def __getitem__(self, idx):
            return self.inputs, self.forcing

    def factory(m_n):
        ds = DS(nu if m_n == n else np.ones((m_n, m_n), np.float32))
        return Poisson2D(DirectField((m_n, m_n)), ds, domain_size=m_n,
                         batch_size=1, loss_type="resmin")

    m = factory(n).to(dev)
    inputs = torch.from_numpy(m.dataset.inputs)[None].to(dev)
    forcing = torch.zeros(1, n, n, 1, device=dev)
    b = torch.from_numpy(np.where(m.dataset.inputs[..., 1:].max(-1) > 0.5, 0,
                                  rng.standard_normal((n, n)))
                         .astype(np.float32)).to(dev)
    b0 = m.residual_for_field(torch.zeros(1, n, n, device=dev), inputs,
                              forcing)[0]

    def A(v):
        return m.residual_for_field(v[None], inputs, forcing)[0] - b0

    sols = {}
    for kernel in (None, "cuda"):
        M, _ = multigrid_preconditioner(factory, n, n_coarse=17,
                                        inputs_per_level="restrict",
                                        stencil_kernel=kernel, device=dev)
        before = k4.launches
        sols[kernel], _ = cg(A, b, tol=0.0, maxiter=14, M=M)
        torch.cuda.synchronize()
        assert (k4.launches > before) == (kernel == "cuda")
        rel = float(torch.linalg.vector_norm(A(sols[kernel]) - b)
                    / torch.linalg.vector_norm(b))
        assert rel < 1e-4, (kernel, rel)
    torch.testing.assert_close(
        sols["cuda"], sols[None], rtol=0,
        atol=1e-3 * float(sols[None].abs().max()))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    tb = _basis(9, 9, dev)
    x = torch.zeros(2, 9, 9, device=dev)
    with pytest.raises(TypeError, match="float32"):
        k1.stiffness_action(x.half(), x.half(), tb)
    with pytest.raises(ValueError, match="contiguous"):
        k1.stiffness_action(x, x.transpose(1, 2), tb)
    with pytest.raises(ValueError, match="device"):
        k2.resmin_loss_grad(x, x, x.cpu(), x[0], tb)


def test_fit_on_the_card_goes_through_the_kernels(dev):
    n = 33
    exact = RectangleManufactured.exact
    ds = RectangleManufactured(n)
    ds.n_samples = 1
    m = Poisson2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                  domain_size=n, batch_size=1, loss_type="resmin",
                  exact_solution=exact,
                  forcing=lambda x, y: 2 * np.pi**2 * exact(x, y),
                  mms_dirichlet=True, fused_kernels=True)
    before = k1.launches
    Trainer(max_epochs=20, optimizer="lbfgs", lbfgs_max_iter=10,
            device=dev).fit(m)
    assert k1.launches > before
    assert m.network.field.device.type == "cuda"
    with torch.no_grad():
        eL2, _, uex = m.calc_l2_err(m.network()[0])
    assert float(eL2 / uex) < 2e-3


# ---- 3D: K5 and K4-3D ---------------------------------------------------

def _basis3(shape, dev, aniso=False):
    nz, ny, nx = shape[1:]
    h = ((0.7 / (nx - 1), 1.9 / (ny - 1), 1.3 / (nz - 1)) if aniso
         else (1 / (nx - 1), 1 / (ny - 1), 1 / (nz - 1)))
    return fem.BasisTables(make_basis(3, 1, h=h)).to(dev)


SHAPES_3D = [((2, 9, 9, 9), True), ((2, 17, 17, 17), False),
             ((2, 20, 17, 17), False), ((1, 129, 129, 129), False),
             ((4, 64, 64, 64), False), ((1, 128, 128, 128), False),
             ((1, 2, 2, 2), False), ((1, 9, 45, 45), True),
             ((2, 3, 17, 17), False), ((1, 65, 65, 65), False),
             ((1, 32, 32, 32), False)]


@pytest.mark.parametrize("shape,aniso", SHAPES_3D)
def test_stiffness3d_kernel_matches_plain(dev, shape, aniso):
    tb = _basis3(shape, dev, aniso)
    u, nu, Nf, bc = _fields(shape, dev)
    bc = (bc > 0.7).float()
    before = k5.launches
    K = k5.stiffness_action_3d(u, nu, tb)
    R = k5.poisson_residual_fused_3d(u, nu, Nf, bc, tb)
    torch.cuda.synchronize()
    assert k5.launches == before + 2
    Kp = k5.stiffness_action_3d_plain(u, nu, tb)
    _field_close(K, Kp)
    _field_close(R, torch.where(bc > 0.5, torch.zeros_like(Kp), Kp - Nf))


@pytest.mark.parametrize("tz", k5.STRIPS)
@pytest.mark.parametrize("shape", [(1, 129, 129, 129), (1, 9, 45, 45),
                                   (2, 3, 17, 17)])
def test_stiffness3d_kernel_every_strip(dev, tz, shape):
    """Each strip length the K5 kernel takes, through its C entry point:
    the last node column right of a tile (129), columns and rows no
    multiple of a block's (45), and fewer planes than a strip (3)."""
    from diffnet_tpu_torch.ops import _build

    lib = _build.load_library()
    tb = _basis3(shape, dev, aniso=shape[2] == 45)
    u, nu = _fields(shape, dev, n=2, seed=5)
    out = torch.empty_like(u)
    assert lib.poisson_stiffness_action_3d(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), *shape, tz,
        *k5.stiffness_consts_3d(tb.basis),
        torch.cuda.current_stream().cuda_stream) == 0
    _field_close(out, k5.stiffness_action_3d_plain(u, nu, tb))


@pytest.mark.parametrize("shape", [(2, 9, 9, 9), (1, 10, 12, 14),
                                   (1, 129, 129, 129), (1, 65, 65, 65),
                                   (1, 33, 33, 33), (1, 17, 17, 17),
                                   (1, 128, 128, 128), (1, 2, 2, 2)])
@pytest.mark.parametrize("shared_c", [False, True])
def test_stencil3d_kernel_matches_plain(dev, shape, shared_c):
    C, = _fields((27, 1 if shared_c else shape[0]) + shape[1:], dev, n=1,
                 seed=7)
    u, = _fields(shape, dev, n=1, seed=8)
    before = (k4.launches, k4.launches_3d)
    out = k4.apply_3d(C - 0.5, u - 0.5)
    torch.cuda.synchronize()
    assert (k4.launches, k4.launches_3d) == (before[0], before[1] + 1)
    _field_close(out, k4.stencil_apply_plain(C - 0.5, u - 0.5))


def test_3d_vjps_match_autograd_through_plain(dev):
    n = 17
    tb = _basis3((2, n, n, n), dev, aniso=True)
    u, nu, w = _fields((2, n, n, n), dev, n=3, seed=9)
    pairs = [(_grads(lambda u, nu: (k5.poisson_stiffness_action_3d(
        u, nu, tb) * w).sum(), u, nu),
        _grads(lambda u, nu: (k5.stiffness_action_3d_plain(u, nu, tb)
                              * w).sum(), u, nu))]
    for cb in (2, 1):
        C, = _fields((27, cb, n, n, n), dev, n=1, seed=10)
        pairs.append((
            _grads(lambda C, u: (k4.stencil_apply(C, u, 3) * w).sum(), C, u),
            _grads(lambda C, u: (k4.stencil_apply_plain(C, u) * w).sum(),
                   C, u)))
    for got, ref in pairs:
        for a, b in zip(got, ref):
            _field_close(a, b)


def test_3d_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    tb = _basis3((1, 5, 5, 5), dev)
    x = torch.zeros(1, 5, 5, 5, device=dev)
    with pytest.raises(ValueError, match="ny == nx"):
        k5.stiffness_action_3d(torch.zeros(1, 5, 4, 5, device=dev),
                               torch.zeros(1, 5, 4, 5, device=dev), tb)
    with pytest.raises(TypeError, match="float32"):
        k5.stiffness_action_3d(x.half(), x.half(), tb)
    with pytest.raises(ValueError, match="C is on cpu"):
        k4.apply_3d(torch.zeros(27, 1, 5, 5, 5), x)


def test_poisson3d_fit_on_the_card_goes_through_k5(dev):
    n = 17
    ds = CuboidManufactured(n)
    ds.n_samples = 1
    m = Poisson3D(DirectField((n,) * 3, init=np.zeros((n,) * 3)), ds,
                  domain_size=n, batch_size=1, loss_type="resmin",
                  exact_solution=ds.exact, forcing=ds.forcing_func,
                  mms_dirichlet=True, fused_kernels=True)
    before = k5.launches
    Trainer(max_epochs=60, optimizer="lbfgs", lbfgs_max_iter=10,
            device=dev).fit(m)
    assert k5.launches > before
    assert m.network.field.device.type == "cuda"
    with torch.no_grad():
        eL2, _, uex = m.calc_l2_err(m.network()[0])
    # the JAX package reaches 2.75e-2 on this run (a CPU run)
    assert float(eL2 / uex) < 1.3 * 2.752e-2


# ---- flow: K6 --------------------------------------------------------------

K6_SHAPES = [(2, 33, True, False), (2, 40, False, True), (2, 65, False, False),
             (1, 129, False, False), (8, 256, False, False),
             (8, 512, False, False), (1, 2, False, False),
             (1, 97, False, False)]


@pytest.mark.parametrize("B,n,aniso,with_f", K6_SHAPES)
def test_ns_kernel_matches_plain(dev, B, n, aniso, with_f):
    tb = _basis(n, n, dev, aniso)
    u, v, p, fx, fy = _fields((B, n, n), dev, n=5, seed=n)
    if not with_f:
        fx = fy = None
    before = k6.launches
    R = k6.ns_vms_residual(u, v, p, fx, fy, tb, 0.01)
    assert k6.launches == before + 1
    for a, b in zip(R, k6.ns_vms_residual_plain(u, v, p, fx, fy, tb, 0.01)):
        torch.testing.assert_close(
            a, b, rtol=0, atol=2e-5 * max(1.0, float(b.abs().max())))


K6_BLOCK_SHAPES = [(1, 33, 129, False), (1, 35, 129, False),
                   (8, 66, 256, False), (2, 9, 32, True), (1, 2, 65, False)]


@pytest.mark.parametrize("B,ny,nx,with_f", K6_BLOCK_SHAPES)
def test_ns_kernel_row_blocks_match_plain(dev, B, ny, nx, with_f):
    """The split route's entry: halo'd row blocks (ny != nx) of an nx^2
    grid, with its spacing; the global entry keeps refusing them."""
    tb = _basis(nx, nx, dev)
    u, v, p, fx, fy = _fields((B, ny, nx), dev, n=5, seed=ny)
    if not with_f:
        fx = fy = None
    before = k6.launches
    R = k6.ns_vms_residual(u, v, p, fx, fy, tb, 0.01, square=False)
    assert k6.launches == before + 1
    for a, b in zip(R, k6.ns_vms_residual_plain(u, v, p, fx, fy, tb, 0.01)):
        torch.testing.assert_close(
            a, b, rtol=0, atol=2e-5 * max(1.0, float(b.abs().max())))
    with pytest.raises(ValueError):
        k6.ns_vms_residual(u, v, p, fx, fy, tb, 0.01)


@pytest.mark.parametrize("ty", [1, 2, 3, 5, 7, 31])
@pytest.mark.parametrize("with_f", [False, True])
def test_ns_kernel_every_strip(dev, ty, with_f):
    """Each strip length the kernel takes, on a grid that is no multiple of
    a block's 31 columns or 4 * ty - 1 rows."""
    from diffnet_tpu_torch.ops import _build

    lib = _build.load_library()
    B, n = 2, 70
    tb = _basis(n, n, dev, aniso=True)
    u, v, p, fx, fy = _fields((B, n, n), dev, n=5, seed=7)
    if not with_f:
        fx = fy = None
    outs = [torch.empty_like(u) for _ in range(3)]
    assert lib.ns_vms_residual(
        u.data_ptr(), v.data_ptr(), p.data_ptr(),
        fx.data_ptr() if with_f else None, fy.data_ptr() if with_f else None,
        *(o.data_ptr() for o in outs), B, n, n, ty, int(with_f),
        *k6.ns_consts(tb.basis, 0.01),
        torch.cuda.current_stream().cuda_stream) == 0
    for a, b in zip(outs, k6.ns_vms_residual_plain(u, v, p, fx, fy, tb,
                                                    0.01)):
        torch.testing.assert_close(
            a, b, rtol=0, atol=2e-5 * max(1.0, float(b.abs().max())))


def test_ns_vjp_and_jvp_match_the_plain_version(dev):
    n = 33
    tb = _basis(n, n, dev, aniso=True)
    uvp = _fields((2, n, n), dev, n=3, seed=1)
    tang = _fields((2, n, n), dev, n=3, seed=2)
    w = _fields((2, n, n), dev, n=3, seed=3)

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in uvp]
        sum((R * ww).sum() for R, ww in zip(
            fn(*xs, None, None, tb, 0.01), w)).backward()
        return [x.grad for x in xs]

    def tangent(fn):
        return torch.func.jvp(lambda *a: fn(*a, None, None, tb, 0.01),
                              tuple(uvp), tuple(tang))[1]

    for got, want in ((grads(k6.ns_vms_residual_fused),
                       grads(k6.ns_vms_residual_plain)),
                      (tangent(k6.ns_vms_residual_fused),
                       tangent(k6.ns_vms_residual_plain))):
        for a, b in zip(got, want):
            _field_close(a, b)


def test_ns_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    tb = _basis(9, 9, dev)
    x = torch.zeros(1, 9, 9, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k6.ns_vms_residual(x, x.transpose(1, 2), x, None, None, tb, 0.01)
    with pytest.raises(ValueError, match="v is on cpu"):
        k6.ns_vms_residual(x, x.cpu(), x, None, None, tb, 0.01)
    with pytest.raises(TypeError, match="float32"):
        k6.ns_vms_residual(x.half(), x.half(), x.half(), None, None, tb,
                           0.01)


def test_ns_newton_solve_on_the_card_goes_through_k6(dev):
    n = 33
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    sols = {}
    for fused in (True, False):
        ds = NSLDCDataset(domain_sizes=(n, n), Re=100)
        ds.n_samples = 1
        m = NavierStokes(None, ds, domain_size=n, batch_size=1, Re=100,
                         u_bc=u_bc, v_bc=v_bc, p_bc=p_bc, fused_kernels=fused)
        before = k6.launches
        sols[fused], info = ns_newton_solve(m, newton_iters=8, device=dev)
        assert (k6.launches > before) == fused
        assert info["residual_history"][-1] < 1e-6, info
    for a, b in zip(sols[True], sols[False]):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_ibn_training_loss_on_the_card_matches_the_cpu(dev):
    """The IBN slice runs no kernel of ours: its winding number, cuDNN
    convolutions (TF32 off) and energy on the card give the CPU's loss and
    parameter gradients, within 1e-5 of the loss and of the largest
    gradient entry."""
    from diffnet_tpu_torch.data import SyntheticPointClouds
    from diffnet_tpu_torch.models import AE
    from diffnet_tpu_torch.pde import IBNPoisson2D

    ds = SyntheticPointClouds(n_samples=16, n_points=120, domain_size=32)
    batch = tuple(torch.from_numpy(np.stack([ds[i][k] for i in range(16)]))
                  for k in range(3))
    out = {}
    for where in ("cpu", dev):
        m = IBNPoisson2D(AE(1, 1, dims=8, n_downsample=2), domain_size=32)
        m.to(where)
        loss = m.training_loss(tuple(t.to(where) for t in batch))
        loss.backward()
        out[str(where)] = (float(loss), {k: p.grad.cpu() for k, p in
                                         m.network.named_parameters()})
    (l_cpu, g_cpu), (l_dev, g_dev) = out.values()
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    for k in g_cpu:
        torch.testing.assert_close(g_dev[k], g_cpu[k], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-10)])
def test_ibn3d_training_loss_on_the_card_matches_the_cpu(dev, dtype, rtol):
    """The 3D IBN step runs no kernel of ours either: a UNet3D's cuDNN
    convolutions (TF32 off) and the 3D energy on the card give the CPU's
    loss and parameter gradients at 32^3, within `rtol` of the loss and of
    the largest gradient entry."""
    from diffnet_tpu_torch.data import TopoDataset3D, synthesize_topology_3d
    from diffnet_tpu_torch.models import UNet3D
    from diffnet_tpu_torch.pde import IBNPoisson3D

    ds = TopoDataset3D([synthesize_topology_3d(n=32, seed=s)
                        for s in range(2)], domain_size=32)
    batch = tuple(torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
                  .to(dtype) for k in range(2))
    out = {}
    for where in ("cpu", dev):
        m = IBNPoisson3D(UNet3D(3, 1, base_filters=4), domain_size=32)
        m.to(where, dtype)
        loss = m.training_loss(tuple(t.to(where) for t in batch))
        loss.backward()
        out[str(where)] = (float(loss), {k: p.grad.cpu() for k, p in
                                         m.network.named_parameters()})
    (l_cpu, g_cpu), (l_dev, g_dev) = out.values()
    assert abs(l_dev - l_cpu) <= rtol * abs(l_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    for k in g_cpu:
        torch.testing.assert_close(g_dev[k], g_cpu[k], rtol=0,
                                   atol=rtol * scale)


def test_dgcnn2d_forward_on_the_card_matches_the_cpu(dev):
    """DGCNN2D (neighbour search by torch.topk, gathers, 1x1 convs,
    GroupNorm), k = 20, 120 points: the card's output within 1e-5 of the
    CPU's largest entry, on 16 uniform random clouds. Slice H's ellipse
    clouds have true ties: in 45 of their 1,920 rows the 20th and 21st
    neighbours lie within 1e-6 (relative, float64) of each other, so
    rounding picks either. There the card's neighbour sets equal the CPU's
    in every row whose 20th and 21st squared distances differ by more than
    1e-5 relative."""
    from diffnet_tpu_torch.data import SyntheticPointClouds
    from diffnet_tpu_torch.models import DGCNN2D, knn_indices

    g = torch.Generator().manual_seed(0)
    pts = torch.rand(16, 120, 2, generator=g)
    net = DGCNN2D(2, domain_size=32, k=20, lowest_size=16)
    with torch.no_grad():
        y_cpu = net(pts)
        y_dev = net.to(dev)(pts.to(dev)).cpu()
    assert y_dev.shape == (16, 32, 32, 1)
    torch.testing.assert_close(y_dev, y_cpu, rtol=0,
                               atol=1e-5 * float(y_cpu.abs().max()))

    ds = SyntheticPointClouds(n_samples=16, n_points=120, domain_size=32)
    ell = torch.from_numpy(np.stack([ds[i][0][:, 0:2] for i in range(16)]))
    i_cpu = knn_indices(ell, 20).sort(-1).values
    i_dev = knn_indices(ell.to(dev), 20).cpu().sort(-1).values
    d2 = torch.sort(torch.cdist(ell.double(), ell.double()) ** 2, -1).values
    clear = (d2[..., 20] - d2[..., 19]) > 1e-5 * d2[..., 20]
    assert clear.float().mean() > 0.9
    assert torch.equal(i_dev[clear], i_cpu[clear])


def _klsum_batch(n, bs, dev):
    from diffnet_tpu_torch.data import KLSumStochastic
    from diffnet_tpu_torch.data.gen_input import sobol_coefficients

    ds = KLSumStochastic(sobol_coefficients(bs, 6, seed=0), domain_size=n)
    return (torch.from_numpy(ds.dataset).to(dev),
            torch.zeros((bs, n, n, 1), device=dev))


@pytest.mark.parametrize("remat", [False, True])
def test_klsum_energy_through_k3_k1_matches_plain(dev, remat):
    """Slice J's step at 64^2 x 32: GoodNetwork(filters=16) on KL-sum
    inputs, the Ritz energy through K3 (forward) and K1 (its VJP), with and
    without remat (the checkpoint recomputes the forward, K3 included, in
    the backward pass), against the plain energy: the loss within 1e-5, the
    parameter gradients within 1e-4 of the largest entry (the energy's
    gradient is a difference of two O(1) projections, summed in another
    order)."""
    from diffnet_tpu_torch.models import GoodNetwork

    n, bs = 64, 32
    batch = _klsum_batch(n, bs, dev)
    out = {}
    for fused in (True, False):
        net = GoodNetwork(in_dim=n, out_dim=n, in_channels=3, filters=16,
                          seed=0)
        m = Poisson2D(net, domain_size=n, loss_type="energy",
                      bc1_value=1.0, bc2_value=0.0, fused_kernels=fused,
                      remat=remat and fused).to(dev)
        l3, l1 = k3.launches, k1.launches
        loss = m.training_loss(batch)
        loss.backward()
        if fused:
            assert k3.launches - l3 == (2 if remat else 1)
            assert k1.launches - l1 == 1
        out[fused] = (float(loss), {k: p.grad for k, p in
                                    net.named_parameters()})
    (lf, gf), (lp, gp) = out[True], out[False]
    assert abs(lf - lp) <= 1e-5 * abs(lp)
    scale = max(float(g.abs().max()) for g in gp.values())
    for k in gp:
        torch.testing.assert_close(gf[k], gp[k], rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_ns_objective_loss_through_k6_matches_plain(dev, idx):
    """Slice K's objectives at 64^2 (the LDC at Re 100, seeded random
    fields): objective_loss(idx) through K6, one launch, against the plain
    residual: the loss within 1e-5 and the field gradients within 2e-5 of
    the largest entry (K6's residuals are held at 2e-5)."""
    n = 64
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    ds = NSLDCDataset(domain_sizes=(n, n), Re=100)
    init = np.random.default_rng(idx).random((n, n)).astype(np.float32)
    out = {}
    for fused in (True, False):
        m = NavierStokes(DirectField((n, n), init=init, n_fields=3), ds,
                         domain_size=n, Re=100, u_bc=u_bc, v_bc=v_bc,
                         p_bc=p_bc, loss_norm="squared",
                         fused_kernels=fused).to(dev)
        batch = tuple(torch.from_numpy(a)[None].to(dev) for a in ds[0])
        before = k6.launches
        loss = m.objective_loss(idx, batch)
        loss.backward()
        assert k6.launches - before == int(fused)
        assert m.objective_param_mask(idx) == (f"field_{idx}",)
        out[fused] = (float(loss), [p.grad for p in m.network.parameters()])
    (lf, gf), (lp, gp) = out[True], out[False]
    assert abs(lf - lp) <= 1e-5 * abs(lp)
    scale = max(float(g.abs().max()) for g in gp)
    for a, b in zip(gf, gp):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * scale)


def _physics_case(kind, n):
    """(module, field, batch) of slice L's card checks at a seeded field."""
    from diffnet_tpu_torch.core.geometry import (sample_ellipse_cloud,
                                                 sample_sphere_cloud)
    from diffnet_tpu_torch.data import AdvDiff2dRectangle
    from diffnet_tpu_torch.pde import AdvDiff2D, Eikonal2D, Eikonal3D

    rng = np.random.default_rng(4)
    if kind == "advdiff":
        ds = AdvDiff2dRectangle(domain_size=n)
        inputs, forcing = (torch.from_numpy(a)[None] for a in ds[0])
        inputs[..., 0] = torch.from_numpy(
            1.0 + 0.5 * rng.random((n, n)).astype(np.float32))
        m = AdvDiff2D(None, ds, diffusivity=0.05, domain_size=n,
                      batch_size=1)
        return m, rng.standard_normal((1, n, n)), (inputs, forcing)
    nsd = 2 if kind == "eikonal2d" else 3
    pts, nrm, area = (sample_ellipse_cloud(80) if nsd == 2
                      else sample_sphere_cloud(400))
    cloud = torch.from_numpy(np.concatenate([pts, nrm, area[:, None]],
                                            -1))[None]
    m = (Eikonal2D if nsd == 2 else Eikonal3D)(
        None, None, domain_size=n, batch_size=1, sdf_weight=100.0,
        normals_weight=10.0)
    return (m, 0.3 * rng.standard_normal((1,) + (n,) * nsd),
            (cloud, torch.zeros((1,) + (n,) * nsd + (1,))))


@pytest.mark.parametrize("kind,n", [("eikonal2d", 64), ("eikonal3d", 32),
                                    ("advdiff", 65)])
def test_physics_loss_on_the_card_matches_the_cpu(dev, kind, n):
    """Slice L runs no kernel of ours: the eikonal losses (grid
    interpolation's gather, the stabilised residual) and the SUPG
    residual on the card give the CPU's loss and field gradient, within
    1e-5 of the loss and of the largest gradient entry."""
    m, u, batch = _physics_case(kind, n)
    out = {}
    for where in ("cpu", dev):
        m.to(where)
        tu = torch.tensor(u, dtype=torch.float32, device=where,
                          requires_grad=True)
        loss = m.loss(tu, *(t.to(where) for t in batch))
        loss.backward()
        out[str(where)] = (float(loss), tu.grad.cpu())
    (l_cpu, g_cpu), (l_dev, g_dev) = out.values()
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    torch.testing.assert_close(g_dev, g_cpu, rtol=0,
                               atol=1e-5 * float(g_cpu.abs().max()))


def test_gauss_newton_step_on_the_card_matches_the_cpu(dev):
    """One Gauss-Newton step of the circle's SDF (the double-VJP products
    and 100 CG iterations on the card) in float64 lands on the CPU's step:
    the losses within 1e-12 of the first (the step cancels ~3e6 of it;
    an H100 read 4.5e-9 relative on the second), the field within 1e-6
    of its largest value (CG at lm 1e-4 amplifies the other summation
    order)."""
    from diffnet_tpu_torch.core.geometry import sample_ellipse_cloud
    from diffnet_tpu_torch.pde import (Eikonal2D, eikonal_gn_residual,
                                       signed_occupancy_init)
    from diffnet_tpu_torch.train import gauss_newton_solve

    n = 32
    pts, nrm, area = sample_ellipse_cloud(100, center=(0.5, 0.5),
                                          radii=(0.25, 0.25))
    cloud = np.concatenate([pts, nrm, area[:, None]], -1)[None]
    u0 = signed_occupancy_init(*(torch.from_numpy(a)[None]
                                 for a in (pts, nrm, area)), (n, n))[0]
    out = {}
    for where in ("cpu", dev):
        m = Eikonal2D(None, None, domain_size=n, batch_size=1,
                      sdf_weight=100.0, normals_weight=10.0)
        x, info = gauss_newton_solve(
            eikonal_gn_residual(m, cloud, device=where),
            u0.double().to(where), newton_iters=1, cg_iters=100, lm=1e-4,
            device=where)
        out[str(where)] = (x.cpu(), info)
    (x_cpu, i_cpu), (x_dev, i_dev) = out.values()
    assert i_dev["gn_iters"] == i_cpu["gn_iters"] == 1
    h_dev, h_cpu = i_dev["loss_history"], i_cpu["loss_history"]
    np.testing.assert_allclose(h_dev, h_cpu, rtol=0, atol=1e-12 * h_cpu[0])
    torch.testing.assert_close(x_dev, x_cpu, rtol=0,
                               atol=1e-6 * float(x_cpu.abs().max()))


def test_topopt_optimize_on_the_card_goes_through_k1(dev):
    """Slice M3's entry point at 17^2, three outer iterations of the JAX
    test's problem: every CG matvec through K1, against the CPU route
    (K1's plain version). The first compliance, the state solve before any
    design step, within 1e-5 relative; the second within 1e-4 (one design
    step, whose median routes cotangents among values that tie by their
    rounding); the designs' volume fraction on target."""
    from diffnet_tpu_torch.pde import TopOpt2D

    n = 17
    x = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(x, x)
    bc2 = np.zeros((n, n)); bc2[0, :] = 1
    inputs = np.stack([np.zeros((n, n)), bc2, xx, yy], -1).astype(np.float32)
    forcing = np.ones((n, n, 1), np.float32)
    hist = {}
    for device in ("cpu", "cuda"):
        m = TopOpt2D(None, None, domain_size=n, target_vf=0.4,
                     compliance_form="variational")
        before = k1.launches
        rho, u, hist[device] = m.optimize(inputs, forcing, n_outer=3,
                                          device=device)
        assert rho.device.type == device and u.device.type == device
        launched = k1.launches - before
        assert (launched > 3) if device == "cuda" else launched == 0
        assert abs(float(m.project_density(rho).mean()) - 0.4) < 1e-4
    assert abs(hist["cuda"][0] / hist["cpu"][0] - 1) <= 1e-5
    assert abs(hist["cuda"][1] / hist["cpu"][1] - 1) <= 1e-4


def test_immersed_energy_step_through_k3_matches_plain(dev):
    """Slice M2's loss: Poisson2D's energy of each immersed instance at its
    64^2 through K3 (forward) and K1 (its VJP) against the plain energy on
    the card: the loss within 1e-5 relative, the field gradient within 1e-5
    of its largest entry."""
    from diffnet_tpu_torch.data import (CircleIMBack, LShaped, RectangleIM,
                                        RectangleIMBack)

    for cls in (RectangleIM, RectangleIMBack, CircleIMBack, LShaped):
        ds = cls()
        ds.n_samples = 1
        n = ds.domain.shape[0]
        batch = tuple(torch.from_numpy(a)[None].to(dev) for a in ds[0])
        init = np.random.default_rng(8).standard_normal((n, n))
        out = {}
        for fused in (True, False):
            m = Poisson2D(DirectField((n, n), init=init), ds, domain_size=n,
                          batch_size=1, fused_kernels=fused).to(dev)
            l3 = k3.launches
            loss = m.training_loss(batch)
            loss.backward()
            assert (k3.launches - l3 == 1) if fused else k3.launches == l3
            out[fused] = (float(loss.detach()), m.network.field.grad)
        (lf, gf), (lp, gp) = out[True], out[False]
        assert abs(lf - lp) <= 1e-5 * abs(lp), cls.__name__
        torch.testing.assert_close(gf, gp, rtol=0,
                                   atol=1e-5 * float(gp.abs().max()))


@pytest.mark.parametrize("shapes", [[(1, 512, 512), (32, 512, 512)],
                                    [(1, 128, 128, 128), (2, 16, 16, 16)]],
                         ids=["k1_512", "k5_128"])
def test_spatial_kernels_over_four_ranks_match_the_unsharded(dev, shapes,
                                                             tmp_path):
    """Slice N1 and N2 on the card: 4 gloo ranks on one card split the rows
    (planes); each rank's block of the spatial K1 / K5 action and of its
    VJPs through the halo exchange against the unsharded kernel's, and
    every rank launched the kernel."""
    from diffnet_tpu_torch.parallel import run_ranks
    from tests import torch_parallel_ranks as ranks

    k1.load_library()   # built once, before the ranks load it
    out = run_ranks(ranks.spatial_cuda_rank, 4, (shapes,),
                    init_method="file://" + str(tmp_path / "rendezvous"),
                    timeout=300.0, threads=2)
    for r in out:
        for shape in shapes:
            res = r[tuple(shape)]
            assert res["launches"][0 if len(shape) == 3 else 1] > 0
            for err, scale in res["errs"]:
                assert err <= 2e-6 * max(1.0, scale), (shape, err, scale)


@pytest.mark.parametrize("nsd", [2, 3], ids=["2d-k1", "3d-k4"])
def test_graphed_vcycle_equals_the_eager_one(dev, nsd):
    """On a card the V-cycle is a CUDA graph: its first call runs eagerly
    and captures it, later calls replay it. A replay on a vector gives the
    eager call's output on it, and counts the kernels' launches as the
    eager call does: K1 on the 2D fine level (``fine_matvec``), K4-3D's
    own count on the assembled 3D levels (``stencil_kernel='cuda'``)."""
    from diffnet_tpu_torch.examples.poisson_mms_2d import (linear_op,
                                                           mms_module)

    if nsd == 2:
        n, mod, name = 65, k1, "launches"
        kw = {"fine_matvec": linear_op(mms_module(n, 1, "resmin", True),
                                       dev)}

        def factory(m):
            return mms_module(m, 1, "resmin", init=False)
    else:
        n, mod, name = 17, k4, "launches_3d"
        kw = {"nsd": 3, "stencil_kernel": "cuda"}

        def factory(m):
            ds = CuboidManufactured(m)
            ds.n_samples = 1
            return Poisson3D(DirectField((m,) * 3), ds, domain_size=m,
                             batch_size=1, loss_type="resmin")

    M, _ = multigrid_preconditioner(factory, n, n_coarse=5, device=dev,
                                    **kw)
    vs = _fields((n,) * nsd, dev, n=3, seed=5)
    k0 = getattr(mod, name)
    want = M(vs[0])             # eager, and captured
    eager = getattr(mod, name) - k0
    assert eager > 0 and M.graph is not None
    for v in (vs[1], vs[0], vs[2]):
        k0 = getattr(mod, name)
        M(v)
        assert getattr(mod, name) - k0 == eager
    _field_close(M(vs[0]), want)


def test_gmres_graph_equals_eager_on_the_ns_jacobian(dev, monkeypatch):
    """krylov.gmres on the card, as newton_solve runs it: one Newton
    direction of the 33^2 cavity through K6, its preconditioned Jacobian
    action replayed as a CUDA graph, against the eager GMRES (CudaGraphed
    swapped for a pass-through) within its tolerance 1e-4, with K6's
    launches counted alike (to one restart cycle: a rounding-level
    difference in a norm may end GMRES a cycle apart)."""
    from diffnet_tpu_torch.train import krylov, stokes_block_preconditioner
    from diffnet_tpu_torch.train.linear import _Stacked

    n = 33
    ds = NSLDCDataset(domain_sizes=(n, n), Re=100.0)
    ds.n_samples = 1
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    m = NavierStokes(None, ds, domain_size=n, batch_size=1, Re=100.0,
                     u_bc=u_bc, v_bc=v_bc, p_bc=p_bc,
                     fused_kernels=True).to(dev)
    inputs = torch.from_numpy(ds[0][0])[None].to(dev)
    st = _Stacked(("u", "v", "p"))

    def F(f):
        R = m.mixed_residual({k: a[None] for k, a in f.items()}, inputs,
                             None)
        return {k: a[0] for k, a in R.items()}

    F, M = st.wrap(F), st.wrap(stokes_block_preconditioner(m, device=dev))
    x = torch.zeros((3, n, n), device=dev)
    Fx = F(x)

    def Jv(v):
        return torch.func.jvp(F, (x,), (v,))[1]

    out = []
    for graphed in (False, True):
        with monkeypatch.context() as mp:
            if not graphed:
                mp.setattr(krylov, "CudaGraphed", lambda fn: fn)
            k0 = k6.launches
            dx, _ = krylov.gmres(Jv, -Fx, M=M, tol=1e-4, maxiter=40,
                                 restart=10)
            out.append((dx, k6.launches - k0))
    (de, ke), (dg, kg) = out
    assert kg > 0 and abs(kg - ke) <= 11
    # within GMRES's own tolerance: the restriction adds with atomics, so
    # neither run is bit-reproducible
    assert float((dg - de).abs().max()) <= 1e-4 * float(de.abs().max())


def test_a_host_read_in_a_graphed_operator_raises(dev):
    """A GMRES operator that reads a value back to the host cannot be
    replayed as a CUDA graph: gmres raises at the capture, naming the rule,
    rather than replaying a branch the host took once; the card runs on
    after it."""
    from diffnet_tpu_torch.train import gmres

    g = torch.Generator().manual_seed(3)
    A = (torch.randn(16, 16, generator=g) + 8 * torch.eye(16)).to(dev)
    b = torch.randn(16, generator=g).to(dev)

    def reads_back(v):
        return A @ v if float(v.norm()) > 0 else v

    with pytest.raises(RuntimeError, match="read nothing back to the host"):
        gmres(reads_back, b, restart=4, maxiter=5)
    x, _ = gmres(lambda v: A @ v, b, restart=4, maxiter=5)
    want = torch.linalg.solve(A, b)
    assert float((x - want).abs().max()) <= 1e-4 * float(want.abs().max())
