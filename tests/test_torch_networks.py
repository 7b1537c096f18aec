"""The port's networks (AE, VAE, UNet, GoodNetwork) against the JAX
package's flax networks, with the flax parameters carried across by
``params_from_jax``.

Tolerances (float32, CPU convolutions summing in other orders): outputs
within 1e-5 of their largest entry; parameter gradients of ``sum(out *
r)`` within 1e-5 of the largest gradient entry of the network (biases ahead
of an InstanceNorm have a zero gradient, so their float32 noise is compared
on that scale, not on their own), 1e-4 for the UNet, whose five stride-2
stages end in InstanceNorms over 2x2 and 1x1 maps. In float64 both agree
to 1e-10 of that scale, the UNet too: the float32 gaps are rounding.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.models import networks as jnets
from diffnet_tpu_torch.interop import params_from_jax
from diffnet_tpu_torch.models import networks as tnets

RTOL = 1e-5
GRAD_RTOL = {"unet": 1e-4}

# name -> (flax network, port network, input shape [B, H, W, C])
NETS = {
    "ae": (lambda: jnets.AE(out_channels=1, dims=4, n_downsample=2),
           lambda: tnets.AE(1, 1, dims=4, n_downsample=2), (2, 16, 16, 1)),
    "ae_3down_2out": (
        lambda: jnets.AE(out_channels=2, dims=2, n_downsample=3),
        lambda: tnets.AE(2, 2, dims=2, n_downsample=3), (2, 16, 16, 2)),
    "vae": (lambda: jnets.VAE(out_channels=1, dims=4, n_downsample=2,
                              latent_channels=8),
            lambda: tnets.VAE(1, 1, dims=4, n_downsample=2,
                              latent_channels=8), (2, 16, 16, 1)),
    "unet": (lambda: jnets.UNet(out_channels=1, base_filters=4),
             lambda: tnets.UNet(3, 1, base_filters=4), (2, 32, 32, 3)),
    "good_32": (lambda: jnets.GoodNetwork(in_dim=32, out_dim=32, filters=4),
                lambda: tnets.GoodNetwork(32, 32, filters=4), (2, 32, 32, 1)),
    # in_dim not a power of 2: an antialiased bilinear shrink to 16, and a
    # bilinear stretch to out_dim
    "good_24_to_20": (
        lambda: jnets.GoodNetwork(in_dim=24, out_dim=20, filters=4),
        lambda: tnets.GoodNetwork(24, 20, filters=4), (2, 24, 24, 1)),
}


def _outputs(y):
    return y if isinstance(y, tuple) else (y,)


def flax_params(jnet, x, seed=1):
    """A parameter tree of `jnet` for input `x`, drawn with numpy: kernels
    normal with variance 1 / fan_in, biases normal at 0.1 (nonzero, so
    their mapping is exercised). The tree's shapes come from
    ``jax.eval_shape`` (flax's own init is slow to compile on a CPU)."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        scale = (1.0 / math.sqrt(math.prod(leaf.shape[:-1]))
                 if len(leaf.shape) > 1 else 0.1)
        return jnp.asarray(scale * rng.standard_normal(leaf.shape),
                           jnp.float32)

    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x))
    return jax.tree.map(draw, shapes)


def _pair(name):
    jf, tf, shape = NETS[name]
    jnet, tnet = jf(), tf()
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    params = flax_params(jnet, x)
    tnet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jnet, tnet, params, x


@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_flax(name):
    jnet, tnet, params, x = _pair(name)
    yj = _outputs(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        yt = _outputs(tnet(torch.from_numpy(x)))
    assert len(yj) == len(yt)
    for a, b in zip(yj, yt):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=RTOL * np.abs(a).max())


def _gradients(name, dtype):
    """The flax network's and the port's parameter gradients of
    ``sum(out * r)``, in `dtype`, and the largest flax entry."""
    jnet, tnet, params, x = _pair(name)
    params = jax.tree.map(lambda a: a.astype(dtype), params)
    tnet.to(torch.float64 if dtype == np.float64 else torch.float32)
    x = x.astype(dtype)
    rng = np.random.default_rng(4)
    r = [rng.standard_normal(o.shape).astype(dtype) for o in
         _outputs(jax.eval_shape(jnet.apply, params, jnp.asarray(x)))]

    def jloss(p):
        return sum(jnp.sum(o * ri) for o, ri in
                   zip(_outputs(jnet.apply(p, jnp.asarray(x))), r))

    gj = params_from_jax(jax.tree.map(np.asarray,
                                    jax.jit(jax.grad(jloss))(params)))
    loss = sum(torch.sum(o * torch.from_numpy(ri)) for o, ri in
               zip(_outputs(tnet(torch.from_numpy(x))), r))
    loss.backward()
    gt = {k: p.grad for k, p in tnet.named_parameters()}
    assert set(gt) == set(gj)
    assert all(gt[k].dtype == gj[k].dtype for k in gj)
    return gj, gt, max(float(g.abs().max()) for g in gj.values())


@pytest.mark.parametrize("name", list(NETS))
def test_parameter_gradients_match_flax(name):
    gj, gt, scale = _gradients(name, np.float32)
    for k in gj:
        np.testing.assert_allclose(
            gt[k].numpy(), gj[k].numpy(),
            atol=GRAD_RTOL.get(name, RTOL) * scale, err_msg=k)


@pytest.mark.parametrize("name", ["ae", "unet", "good_24_to_20"])
def test_parameter_gradients_match_flax_in_float64(name):
    with jax.enable_x64(True):
        gj, gt, scale = _gradients(name, np.float64)
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), gj[k].numpy(),
                                   atol=1e-10 * scale, err_msg=k)


def test_state_dict_names_are_the_flax_tree():
    """Every flax leaf has a port parameter of the same shape, and no port
    parameter is left over."""
    jnet, tnet, params, _ = _pair("good_32")
    carried = params_from_jax(jax.tree.map(np.asarray, params))
    own = tnet.state_dict()
    assert set(carried) == set(own)
    assert all(carried[k].shape == own[k].shape for k in own)
    assert "Down_1.Conv_0.weight" in own and "Up_0.ConvTranspose_0.weight" \
        in own


@pytest.mark.parametrize("name", ["ae", "unet", "good_32"])
def test_init_follows_flax_lecun_normal(name):
    """Kernels start as flax's lecun_normal: a normal cut at two standard
    deviations, std sqrt(1 / fan_in) before the cut (fan_in = kh kw C_in,
    also for transpose convs); biases at zero; the same seed gives the same
    weights."""
    _, tf, _ = NETS[name]
    net = tf()
    assert all(torch.equal(a, b) for a, b in
               zip(net.state_dict().values(), tf().state_dict().values()))
    for k, w in net.state_dict().items():
        if k.endswith("bias"):
            assert not w.any(), k
            continue
        fan_in = (w.shape[0] if "ConvTranspose" in k else w.shape[1]) \
            * w.shape[2] * w.shape[3]
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std * (1 + 1e-6), k
        if w.numel() >= 500:   # the cut normal's std is sqrt(1 / fan_in)
            assert abs(float(w.std()) / math.sqrt(1.0 / fan_in) - 1) < 0.15, k


def test_dropout_follows_the_train_flag_not_module_mode():
    """``module.train()`` (what Trainer.fit calls) leaves dropout off: the
    JAX package never trains with it. ``forward(x, train=True)`` turns it
    on."""
    net = tnets.UNet(1, 1, base_filters=4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 1)).astype(np.float32))
    net.eval()
    with torch.no_grad():
        y_eval = net(x)
        net.train()
        assert torch.equal(net(x), y_eval)
        torch.manual_seed(0)
        assert not torch.equal(net(x, train=True), y_eval)
    good = tnets.GoodNetwork(32, 32, filters=4).train()
    with torch.no_grad():
        assert torch.equal(good(x), good(x))


def test_vae_sample_draws_around_mu():
    """``sample=True`` decodes mu + exp(logvar / 2) eps: other outputs than
    the mean's, the same mu and logvar."""
    net = tnets.VAE(1, 1, dims=4, n_downsample=2, latent_channels=8)
    x = torch.rand(2, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, mu, logvar = net(x)
        out_s, mu_s, logvar_s = net(
            x, sample=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(mu, mu_s) and torch.equal(logvar, logvar_s)
    assert mu.shape == (2, 4, 4, 8) and not torch.equal(out, out_s)


def test_goodnetwork_refuses_small_inputs():
    with pytest.raises(ValueError, match="in_dim > 8"):
        tnets.GoodNetwork(8, 8)
