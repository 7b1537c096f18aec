"""The port's U-Nets and IBN energies split over the 'space' axis of a
process mesh (``UNet(mesh=)``, ``UNet3D(mesh=)``, ``IBNPoisson2D(mesh=)``,
``IBNPoisson3D(mesh=)``, ``NumpyLoader(space_axis=)``, the Trainer's
'space' reduction) against one process, and the split dry-run workload
(a) against the JAX package, which partitions the same network by GSPMD
(``__graft_entry__.py``'s ``P("data", "space", None, None)``).

One module-scoped spawn of 4 gloo ranks on the CPU
(tests/torch_spatial_net_ranks.py::nets_rank) computes each rank's blocks
under meshes of ``1 x 2``, ``1 x 4`` and ``2 x 2``; the JAX reference runs
here meanwhile.

Tolerances (float64 unless stated): the gather and scatter pass
``gradcheck``; the stages, the networks' outputs and the energies within
1e-10 relative (the split sums the same terms in another order: a norm's
two sums in k partial sums, an energy's element sums per rank); the
gradients within 1e-9 of the reference's L2 norm. A mesh of one 'space'
rank gives the unsplit net bit for bit. One Trainer step (Adam, lr 1e-3)
against one process: the loss within 1e-10 relative, the gradients within
1e-9 of their norm, the parameters within 1e-12 (lr g / (|g| + eps)
rounds in the last bits; no gradient here sits near Adam's eps). Workload
(a) in float32 against JAX's ``value_and_grad`` and ``optax.adam`` from
one ``seeded_params`` tree: the loss within 1e-5 relative, the gradient
within 1e-5 of its L2 norm and the parameters after the step within 1e-6
(as tests/test_torch_parallel.py holds its data-parallel step to JAX).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffnet_tpu.models.networks import UNet as JUNet
from diffnet_tpu.pde.ibn import IBNPoisson2D as JIBNPoisson2D
from diffnet_tpu_torch.interop import (flax_shapes, params_from_jax,
                                       seeded_params)
from diffnet_tpu_torch.models import UNet
from diffnet_tpu_torch.parallel import block_bounds, run_ranks
from tests import torch_spatial_net_ranks as ranks

WORLD = 4
RTOL = 1e-10          # outputs, losses, energies: relative
GRAD_RTOL = 1e-9      # gradients: of the reference's L2 norm
PARAM_ATOL = 1e-12    # parameters after one float64 Adam step
JAX_RTOL = 1e-5       # workload (a) in float32: loss, gradient of its norm
JAX_PARAM_ATOL = 1e-6
SPACE = {"1x2": 2, "1x4": 4, "2x2": 2}
OP_SHAPES = {("down", 2): (2, 3, 16, 8), ("up", 2): (2, 4, 8, 6),
             ("head", 2): (2, 4, 8, 6), ("norm", 2): (2, 3, 8, 5),
             ("down", 3): (1, 2, 8, 6, 6), ("up", 3): (1, 2, 4, 3, 3),
             ("head", 3): (1, 2, 4, 3, 3), ("norm", 3): (1, 2, 4, 3, 5)}
ENERGY_CASES = (("2d", 33), ("3d", 17))   # 33 and 17 rows split unevenly


def _payload():
    rng = np.random.default_rng(0)
    ops = {}
    for key, shape in OP_SHAPES.items():
        x = rng.standard_normal(shape)
        y, _ = ranks.run_op(*key, torch.tensor(x))
        ops[key] = (x, rng.standard_normal(tuple(y.shape)))
    nets = {kind: (rng.random((4,) + (32,) * nd + (3,)),
                   rng.random((4,) + (32,) * nd + (1,)))
            for kind, nd in (("2d", 2), ("3d", 3))}
    energies = {}
    for kind, n in ENERGY_CASES:
        shape = (2,) + (n,) * (2 if kind == "2d" else 3)
        energies[kind, n] = (rng.random(shape), rng.random(shape + (3,)),
                             rng.random(shape + (1,)))
    # the dry run's workload (a) at 4 ranks (data 2, batch 2 a data rank),
    # its draws in its order, from JAX's initial tree
    drng = np.random.default_rng(0)
    tree = seeded_params(flax_shapes(UNet(3, 1, base_filters=4)), 2)
    dry = {"inputs": drng.random((4, 32, 32, 3)).astype(np.float32),
           "forcing": drng.random((4, 32, 32, 1)).astype(np.float32),
           "state": {k: v.numpy() for k, v in
                     params_from_jax(tree).items()}}
    return {"gradcheck": rng.standard_normal((2, 8, 3)), "ops": ops,
            "nets": nets, "energies": energies, "dryrun_a": dry}, tree


def _jax_step(tree, a):
    """JAX's loss, gradient and Adam step (lr 1e-3) of workload (a) on one
    CPU device."""
    jm = JIBNPoisson2D(JUNet(out_channels=1, base_filters=4),
                       source_from="inputs", domain_size=32, batch_size=4)
    params = jax.tree.map(jnp.asarray, {"params": tree})
    batch = (jnp.asarray(a["inputs"]), jnp.asarray(a["forcing"]))
    loss, grads = jax.jit(jax.value_and_grad(jm.training_loss))(params,
                                                                 batch)
    opt = optax.adam(1e-3)
    upd, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, upd)
    as_np = (lambda t: {k: np.asarray(v) for k, v in
                        params_from_jax(jax.tree.map(np.asarray, t)).items()})
    return {"loss": float(loss), "grads": as_np(grads["params"]),
            "params": as_np(new)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' results and JAX's step of workload (a), computed here
    while the ranks run."""
    p, tree = _payload()
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, ranks.nets_rank, WORLD, (p,),
                              init_method=init, timeout=120.0, threads=1)
        jax_a = _jax_step(tree, p["dryrun_a"])
        out = spawned.result()
    return p, out, jax_a


@pytest.fixture(scope="module")
def run(results):
    return results[:2]


def _ranks_of(name):
    """The ranks of one mesh of `name`, in mesh order (a 1 x 2 mesh: ranks
    0 and 1; ranks 2 and 3 form another)."""
    return list(range(2)) if name == "1x2" else list(range(WORLD))


def _rows(blocks, axis, name):
    """The global tensor from the mesh's ranks' blocks: 'space' blocks
    along `axis` within each data row, the data rows along axis 0."""
    k = SPACE[name]
    rows = [np.concatenate(blocks[d * k:(d + 1) * k], axis=axis)
            for d in range(len(blocks) // k)]
    return np.concatenate(rows, axis=0)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _grads_close(got, want, rtol=GRAD_RTOL):
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in want.values()))
    assert got.keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, atol=rtol * norm,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["1x2", "1x4"])
@pytest.mark.parametrize("check", ["gather_scatter", "scatter_gather"])
def test_gather_and_scatter_pass_gradcheck(run, name, check):
    """gather then scatter is the identity on a rank's block, and scatter
    then gather the identity on its own rows, in value and in gradient
    (each rank backpropagating its share: the all-reduced cotangent of its
    block)."""
    _, out = run
    assert all(out[r]["gradcheck"][name][check] for r in range(WORLD))


@pytest.mark.parametrize("name", ["1x2", "1x4"])
@pytest.mark.parametrize("key", list(OP_SHAPES), ids=lambda k: f"{k}")
def test_split_stage_equals_the_unsplit_one(run, name, key):
    """Each halo'd stage (Down's stride-2 conv and norm, Up's transposed
    conv and norm, the resize and head conv) and the all-reduced instance
    norm: this rank's rows of the unsplit output, its rows of the input's
    VJP, and the weights' VJP summed over the ranks."""
    p, out = run
    x, g = p["ops"][key]
    xt = torch.tensor(x, requires_grad=True)
    y, op = ranks.run_op(*key, xt)
    (y * torch.tensor(g)).sum().backward()
    got = [out[r]["ops"][name][key] for r in _ranks_of(name)]
    _close(np.concatenate([o["y"] for o in got], axis=2), y.detach().numpy())
    dx = xt.grad.numpy()
    _close(np.concatenate([o["dx"] for o in got], axis=2), dx,
           GRAD_RTOL * np.sqrt((dx ** 2).sum()) / np.abs(dx).max())
    if op is not None:
        dw = next(op.parameters()).grad.numpy()
        _close(sum(o["dw"] for o in got), dw,
               GRAD_RTOL * np.sqrt((dw ** 2).sum()) / np.abs(dw).max())


@pytest.fixture(scope="module")
def one_process(run):
    """Each network on the global batch in one process: output, loss and
    gradients."""
    p, _ = run
    refs = {}
    for kind, (inputs, forcing) in p["nets"].items():
        net = ranks.net_for(kind)
        m = ranks.module_for(kind, net, inputs.shape[1], len(inputs))
        xin, xf = torch.tensor(inputs), torch.tensor(forcing)
        loss = m.training_loss((xin, xf))
        loss.backward()
        with torch.no_grad():
            y = net(xin).numpy()
        refs[kind] = {"y": y, "loss": float(loss.detach()),
                      "grads": {k: v.grad.numpy() for k, v in
                                net.named_parameters()}}
    return refs


@pytest.mark.parametrize("name", ["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_split_unet_equals_one_process(run, one_process, name, kind):
    """UNet(4) at 32^2 and UNet3D(2) at 32^3 (rows or depth planes split;
    over 2 ranks the fifth Down runs gathered, over 4 the fourth and fifth)
    under the IBN energy: each rank's block of the output, the loss and
    every gradient (averaged over 'space', then 'data') equal one
    process's on the global batch."""
    _, out = run
    want = one_process[kind]
    got = [out[r]["nets"][name][kind] for r in _ranks_of(name)]
    _close(_rows([o["y"] for o in got], 1, name), want["y"])
    for o in got:
        np.testing.assert_allclose(o["loss"], want["loss"], rtol=RTOL)
        _grads_close(o["grads"], want["grads"])


@pytest.mark.parametrize("name", ["1x2", "1x4"])
@pytest.mark.parametrize("case", ENERGY_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_split_ibn_energy_equals_the_unsplit_one(run, name, case):
    """IBNPoisson2D's and IBNPoisson3D's energies of fields split unevenly
    (block_bounds: 33 rows as 16 + 17 or 8 + 8 + 8 + 9) equal the unsplit
    energy on every rank; each rank's gradient in its block of u is
    ``space`` times its rows of the unsplit gradient (the loss computed in
    full on every rank, see parallel.all_reduce_sum)."""
    p, out = run
    kind, n = case
    u, inputs, forcing = p["energies"][case]
    m = ranks.module_for(kind, ranks.net_for(kind), n, len(u))
    ut = torch.tensor(u, requires_grad=True)
    e = m.loss(ut, torch.tensor(inputs), torch.tensor(forcing))
    e.backward()
    got = [out[r]["energies"][name][case] for r in _ranks_of(name)]
    for o in got:
        np.testing.assert_allclose(o["energy"], float(e.detach()), rtol=RTOL)
    b = block_bounds(n, SPACE[name])
    assert [o["du"].shape[1] for o in got] == [
        b1 - b0 for b0, b1 in zip(b, b[1:])]
    du = np.concatenate([o["du"] for o in got], axis=1) / SPACE[name]
    _close(du, ut.grad.numpy(), GRAD_RTOL * np.sqrt((du ** 2).sum())
           / np.abs(du).max())


def test_one_space_rank_runs_the_unsplit_code(run):
    """A UNet on a 4 x 1 mesh (no split) gives the unsplit net's output
    bit for bit."""
    _, out = run
    assert all(o["no_split"] for o in out)


@pytest.mark.parametrize("name", ["1x4", "2x2"])
def test_trainer_step_over_space_equals_one_process(run, name):
    """One Adam step through Trainer.fit with the loader splitting the
    fields over 'space' (space_axis=1): the step's loss, the gradients it
    left and the parameters after it, on every rank, against one process
    on the global batch."""
    p, out = run
    inputs, forcing = p["nets"]["2d"]
    want = ranks.fit_step("2d", inputs, forcing)
    for o in out:
        got = o["fit"][name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        _grads_close(got["grads"], want["grads"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


def test_split_dryrun_workload_a_matches_jax(results):
    """The dry run's workload (a) as it now runs at 4 ranks (2 x 2, the
    32^2 rows split over 'space'), in float32 from the JAX tree: the loss,
    the gradient and the parameters after the Adam step against JAX's
    value_and_grad and optax.adam on one CPU device."""
    _, out, want = results
    for o in out:
        got = o["dryrun_a"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=JAX_RTOL)
        _grads_close(got["grads"], want["grads"], JAX_RTOL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=JAX_PARAM_ATOL, err_msg=k)
