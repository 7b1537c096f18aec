"""The port's point-cloud networks (MLP, ConvNet1D, the ImmDiff family,
EikonalLinear, DGCNN2D) and the DGCNN neighbour graph (``knn_indices``,
``graph_feature``) against the JAX package's, with the flax parameters
carried across by ``params_from_jax``.

Tolerances as in test_torch_networks.py: outputs within 1e-5 of their
largest entry (float32), parameter gradients of ``sum(out * r)`` within
1e-5 of the largest gradient entry in float32 and 1e-10 in float64; the
neighbour sets equal (``torch.topk`` may order ties otherwise than
``jax.lax.top_k``, so each row's set is compared, on clouds without
repeated points) and the edge features within 1e-6 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.models import pointnets as jpn
from diffnet_tpu_torch.interop import flax_shapes, params_from_jax
from diffnet_tpu_torch.models import pointnets as tpn

from .test_torch_networks import flax_params, shape_tree

RTOL = 1e-5
NP = 16     # points a cloud

# name -> (flax network, port network, input shapes)
NETS = {
    "mlp_tanh": (
        lambda: jpn.MLP([8, 8, 3], nonlin=jnp.tanh, final_nonlin=jnp.sin),
        lambda: tpn.MLP(4, [8, 8, 3], nonlin=torch.tanh,
                        final_nonlin=torch.sin), [(2, 5, 4)]),
    "convnet1d": (lambda: jpn.ConvNet1D([4, 3], out_channels=2),
                  lambda: tpn.ConvNet1D(3, [4, 3], out_channels=2),
                  [(2, 5, 3)]),
    "convnet1d_k3": (lambda: jpn.ConvNet1D([4], kernel=3),
                     lambda: tpn.ConvNet1D(2, [4], kernel=3), [(2, 5, 2)]),
    "convnet1d_k4": (lambda: jpn.ConvNet1D([3], kernel=4),
                     lambda: tpn.ConvNet1D(2, [3], kernel=4), [(2, 6, 2)]),
    # the latent grid grows by a bilinear resize (8 -> 16)
    "immdiff": (
        lambda: jpn.ImmDiff(out_size=16, latent_hw=8, hidden=16,
                            n_hidden=2),
        lambda: tpn.ImmDiff(NP, out_size=16, latent_hw=8, hidden=16,
                            n_hidden=2), [(2, NP, 2)]),
    # ... and shrinks (12 -> 8, antialiased)
    "immdiff_shrink": (
        lambda: jpn.ImmDiff(out_channels=2, out_size=8, latent_hw=12,
                            hidden=8, n_hidden=1),
        lambda: tpn.ImmDiff(NP, out_channels=2, out_size=8, latent_hw=12,
                            hidden=8, n_hidden=1), [(2, NP, 2)]),
    "immdiff_vae": (
        lambda: jpn.ImmDiffVAE(out_size=16, latent_dim=4, hidden=8),
        lambda: tpn.ImmDiffVAE(NP, out_size=16, latent_dim=4, hidden=8),
        [(2, NP, 2)]),
    "immdiff_large": (lambda: jpn.ImmDiffLarge(out_size=32),
                      lambda: tpn.ImmDiffLarge(NP, out_size=32),
                      [(2, NP, 2)]),
    "immdiff_large_normals": (
        lambda: jpn.ImmDiffLargeNormals(out_size=16),
        lambda: tpn.ImmDiffLargeNormals(NP, out_size=16),
        [(2, NP, 2), (2, NP, 2)]),
    "eikonal_linear": (lambda: jpn.EikonalLinear(width=8, depth=3),
                       lambda: tpn.EikonalLinear(2, 1, width=8, depth=3),
                       [(2, 7, 2)]),
    # lowest 8 -> one 2-channel stage to 16, then the 1-channel one to 32
    "dgcnn": (lambda: jpn.DGCNN2D(domain_size=32, k=5, lowest_size=8),
              lambda: tpn.DGCNN2D(2, domain_size=32, k=5, lowest_size=8),
              [(2, NP, 2)]),
    # k above Np - 1: min(k, Np - 1) neighbours; no transpose stage
    "dgcnn_k_capped": (
        lambda: jpn.DGCNN2D(domain_size=16, k=30, lowest_size=8),
        lambda: tpn.DGCNN2D(2, domain_size=16, k=30, lowest_size=8),
        [(2, NP, 2)]),
}
GRAD64 = ["mlp_tanh", "convnet1d_k3", "immdiff_shrink", "immdiff_vae",
          "immdiff_large_normals", "dgcnn"]


def _outputs(y):
    return y if isinstance(y, tuple) else (y,)


def _inputs(shapes, dtype=np.float32):
    rng = np.random.default_rng(3)
    return [rng.uniform(0, 1, s).astype(dtype) for s in shapes]


def _pair(name):
    jf, tf, shapes = NETS[name]
    jnet, tnet = jf(), tf()
    xs = _inputs(shapes)
    params = flax_params(jnet, *xs)
    tnet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jnet, tnet, params, xs


@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_flax(name):
    jnet, tnet, params, xs = _pair(name)
    yj = _outputs(jax.jit(jnet.apply)(params, *map(jnp.asarray, xs)))
    with torch.no_grad():
        yt = _outputs(tnet(*map(torch.from_numpy, xs)))
    assert len(yj) == len(yt)
    for a, b in zip(yj, yt):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=RTOL * np.abs(a).max())


def _gradients(name, dtype):
    jnet, tnet, params, xs = _pair(name)
    params = jax.tree.map(lambda a: a.astype(dtype), params)
    tnet.to(torch.float64 if dtype == np.float64 else torch.float32)
    xs = [x.astype(dtype) for x in xs]
    rng = np.random.default_rng(4)
    r = [rng.standard_normal(o.shape).astype(dtype) for o in _outputs(
        jax.eval_shape(jnet.apply, params, *map(jnp.asarray, xs)))]

    def jloss(p):
        return sum(jnp.sum(o * ri) for o, ri in
                   zip(_outputs(jnet.apply(p, *map(jnp.asarray, xs))), r))

    gj = params_from_jax(jax.tree.map(np.asarray,
                                      jax.jit(jax.grad(jloss))(params)))
    loss = sum(torch.sum(o * torch.from_numpy(ri)) for o, ri in
               zip(_outputs(tnet(*map(torch.from_numpy, xs))), r))
    loss.backward()
    gt = {k: p.grad for k, p in tnet.named_parameters()}
    assert set(gt) == set(gj)
    return gj, gt, max(float(g.abs().max()) for g in gj.values())


@pytest.mark.parametrize("name", list(NETS))
def test_parameter_gradients_match_flax(name):
    gj, gt, scale = _gradients(name, np.float32)
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), gj[k].numpy(),
                                   atol=RTOL * scale, err_msg=k)


@pytest.mark.parametrize("name", GRAD64)
def test_parameter_gradients_match_flax_in_float64(name):
    with jax.enable_x64(True):
        gj, gt, scale = _gradients(name, np.float64)
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), gj[k].numpy(),
                                   atol=1e-10 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["immdiff_large_normals", "dgcnn",
                                  "immdiff_vae"])
def test_state_dict_names_are_the_flax_tree(name):
    jnet, tnet, params, _ = _pair(name)
    carried = params_from_jax(jax.tree.map(np.asarray, params))
    own = tnet.state_dict()
    assert set(carried) == set(own)
    assert all(carried[k].shape == own[k].shape for k in own)


def _cloud(b=3, n=40, c=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, n, c)).astype(
        np.float32)


@pytest.mark.parametrize("name", list(NETS))
def test_flax_shapes_are_the_flax_tree(name):
    """flax_shapes of the port's network is the shape tree of the flax
    network's parameters (1D conv kernels, Dense kernels)."""
    jf, tf, shapes = NETS[name]
    want = jax.eval_shape(jf().init, jax.random.key(0),
                          *(jnp.zeros(s, jnp.float32) for s in shapes))
    assert flax_shapes(tf()) == shape_tree(want["params"])


@pytest.mark.parametrize("c,k", [(2, 20), (16, 7)])
def test_knn_neighbour_sets_match_jax(c, k):
    x = _cloud(c=c)
    ij = np.asarray(jpn.knn_indices(jnp.asarray(x), k))
    it = tpn.knn_indices(torch.from_numpy(x), k).numpy()
    assert it.shape == ij.shape == (3, 40, k)
    np.testing.assert_array_equal(np.sort(it, -1), np.sort(ij, -1))
    assert (it[..., 0] == np.arange(40)).all()   # each point is its nearest


def test_graph_feature_matches_jax():
    x = _cloud(c=3)
    fj = np.asarray(jpn.graph_feature(jnp.asarray(x), 6))
    ft = tpn.graph_feature(torch.from_numpy(x), 6).numpy()
    assert ft.shape == (3, 40, 6, 6)
    # the same neighbours in JAX's order, then the features equal
    idx = np.asarray(jpn.knn_indices(jnp.asarray(x), 6))
    ft_j = tpn.graph_feature(torch.from_numpy(x), 6,
                             idx=torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(ft_j, fj, atol=1e-6 * np.abs(fj).max())
    np.testing.assert_allclose(np.sort(ft, 2), np.sort(fj, 2),
                               atol=1e-6 * np.abs(fj).max())


def test_immdiff_vae_sample_draws_around_mu():
    net = tpn.ImmDiffVAE(NP, out_size=16, latent_dim=4, hidden=8)
    x = torch.rand(2, NP, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, mu, logvar = net(x)
        out_s, mu_s, _ = net(x, sample=True,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(mu, mu_s) and mu.shape == (2, 4)
    assert out.shape == (2, 16, 16, 1) and not torch.equal(out, out_s)
