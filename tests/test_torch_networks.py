"""The port's networks (AE, VAE, UNet, UNet3D, MultiOutUNet, GoodNetwork,
UNetRes, ImplicitConv, ResNetED, LocalConv2d) against the JAX package's
flax networks, with the flax parameters carried across by
``params_from_jax``.

Tolerances (float32, CPU convolutions summing in other orders): outputs
within 1e-5 of their largest entry; parameter gradients of ``sum(out *
r)`` within 1e-5 of the largest gradient entry of the network (biases ahead
of an InstanceNorm have a zero gradient, so their float32 noise is compared
on that scale, not on their own), 1e-4 for the UNet, whose five stride-2
stages end in InstanceNorms over 2x2 and 1x1 maps (the 3D and multi-output
U-Nets too) and for the gated UNetRes, whose deepest GroupNorms run over
4x4 maps of one channel a group. In float64 both agree to 1e-10 of that
scale, these too: the float32 gaps are rounding. LocalConv2d is held to
1e-5 in float64 as well: the JAX package's einsum returns float32
(``preferred_element_type=jnp.float32``) whatever the input type.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.models import networks as jnets
from diffnet_tpu_torch.interop import (flax_shapes, params_from_jax,
                                       seeded_params)
from diffnet_tpu_torch.models import networks as tnets

RTOL = 1e-5
GRAD_RTOL = {"unet": 1e-4, "unet3d": 1e-4, "multiout_unet": 1e-4,
             "unetres_gated": 1e-4}
F64_RTOL = {"local_conv": RTOL}

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
    # the smallest side a 5-stage U-Net takes, narrow
    "unet3d": (lambda: jnets.UNet3D(out_channels=1, base_filters=2),
               lambda: tnets.UNet3D(3, 1, base_filters=2), (1, 32, 32, 32, 3)),
    "multiout_unet": (
        lambda: jnets.MultiOutUNet(num_outputs=2, base_filters=2),
        lambda: tnets.MultiOutUNet(1, 2, 1, base_filters=2), (2, 32, 32, 1)),
    "unetres": (
        lambda: jnets.UNetRes(hidden=(4, 8), n_resblocks=1, n_dilated=2),
        lambda: tnets.UNetRes(1, 1, hidden=(4, 8), n_resblocks=1,
                              n_dilated=2), (2, 16, 16, 1)),
    "unetres_gated": (
        lambda: jnets.UNetRes(out_channels=2, hidden=(4, 8, 16),
                              n_resblocks=2, n_dilated=1, gated=True),
        lambda: tnets.UNetRes(2, 2, hidden=(4, 8, 16), n_resblocks=2,
                              n_dilated=1, gated=True), (2, 16, 16, 2)),
    "implicit_conv": (
        lambda: jnets.ImplicitConv(out_channels=2, width=8, depth=4),
        lambda: tnets.ImplicitConv(3, 2, width=8, depth=4), (2, 8, 8, 3)),
    "resnet_ed": (
        lambda: jnets.ResNetED(base_filters=4, n_down=2, n_blocks=1),
        lambda: tnets.ResNetED(1, 1, base_filters=4, n_down=2, n_blocks=1),
        (2, 16, 16, 1)),
    "local_conv": (
        lambda: jnets.LocalConv2d(features=3, kernel=(3, 2), in_size=(8, 10),
                                  in_channels=2),
        lambda: tnets.LocalConv2d(3, (3, 2), (8, 10), 2), (2, 8, 10, 2)),
}
NEW_NETS = ["unet3d", "multiout_unet", "unetres", "unetres_gated",
            "implicit_conv", "resnet_ed", "local_conv"]


def _outputs(y):
    return y if isinstance(y, tuple) else (y,)


def flax_params(jnet, *xs, seed=1):
    """A parameter tree of `jnet` for inputs `xs`, drawn with numpy: kernels
    normal with variance 1 / fan_in, biases normal at 0.1 (nonzero, so
    their mapping is exercised). The tree's shapes come from
    ``jax.eval_shape`` (flax's own init is slow to compile on a CPU)."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        scale = (1.0 / math.sqrt(math.prod(leaf.shape[:-1]))
                 if len(leaf.shape) > 1 else 0.1)
        return jnp.asarray(scale * rng.standard_normal(leaf.shape),
                           jnp.float32)

    shapes = jax.eval_shape(jnet.init, jax.random.key(0),
                            *map(jnp.asarray, xs))
    return jax.tree.map(draw, shapes)


def shape_tree(tree):
    """Nested dicts of the leaves' shapes."""
    return {k: shape_tree(v) if hasattr(v, "items") else tuple(v.shape)
            for k, v in tree.items()}


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


@pytest.mark.parametrize("name", ["ae", "unet", "good_24_to_20"] + NEW_NETS)
def test_parameter_gradients_match_flax_in_float64(name):
    with jax.enable_x64(True):
        gj, gt, scale = _gradients(name, np.float64)
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), gj[k].numpy(),
                                   atol=F64_RTOL.get(name, 1e-10) * scale,
                                   err_msg=k)


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


@pytest.mark.parametrize("name", ["ae", "unet", "good_32", "unet3d",
                                  "resnet_ed"])
def test_init_follows_flax_lecun_normal(name):
    """Kernels start as flax's lecun_normal: a normal cut at two standard
    deviations, std sqrt(1 / fan_in) before the cut (fan_in = kh kw C_in,
    also for transpose convs; kh kw kd C_in in 3D); biases at zero; the
    same seed gives the same weights."""
    _, tf, _ = NETS[name]
    net = tf()
    assert all(torch.equal(a, b) for a, b in
               zip(net.state_dict().values(), tf().state_dict().values()))
    for k, w in net.state_dict().items():
        if k.endswith("bias"):
            assert not w.any(), k
            continue
        fan_in = (w.shape[0] if "ConvTranspose" in k else w.shape[1]) \
            * math.prod(w.shape[2:])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std * (1 + 1e-6), k
        if w.numel() >= 500:   # the cut normal's std is sqrt(1 / fan_in)
            assert abs(float(w.std()) / math.sqrt(1.0 / fan_in) - 1) < 0.15, k


@pytest.mark.parametrize("name", NEW_NETS)
def test_state_dict_of_every_new_network_is_the_flax_tree(name):
    """params_from_jax gives exactly the port's state dict, shape for
    shape: flax's names, and the layouts of 3D kernels, GroupNorm scales
    and LocalConv2d's per-location kernel."""
    jnet, tnet, params, _ = _pair(name)
    carried = params_from_jax(jax.tree.map(np.asarray, params))
    own = tnet.state_dict()
    assert set(carried) == set(own)
    assert all(carried[k].shape == own[k].shape for k in own)


@pytest.mark.parametrize("name", list(NETS))
def test_flax_shapes_are_the_flax_tree(name):
    """flax_shapes of the port's network is the shape tree of the flax
    network's parameters, leaf for leaf (the inverse of params_from_jax's
    layouts)."""
    jf, tf, shape = NETS[name]
    want = jax.eval_shape(jf().init, jax.random.key(0),
                          jnp.zeros(shape, jnp.float32))["params"]
    assert flax_shapes(tf()) == shape_tree(want)


@pytest.mark.parametrize("name", ["unet3d", "unetres_gated", "local_conv"])
def test_seeded_params_are_one_network_in_both_packages(name):
    """A tree drawn by seeded_params loads into the port whole and gives
    the flax network's output (a 3D U-Net, GroupNorm scales at one, a
    LocalConv2d kernel); kernels follow flax's lecun_normal, biases zero."""
    jf, tf, shape = NETS[name]
    tnet = tf()
    tree = seeded_params(flax_shapes(tnet), seed=5)
    tnet.load_state_dict(params_from_jax(tree))
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    yj = _outputs(jax.jit(jf().apply)({"params": jax.tree.map(
        jnp.asarray, tree)}, jnp.asarray(x)))
    with torch.no_grad():
        yt = _outputs(tnet(torch.from_numpy(x)))
    for a, b in zip(yj, yt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=RTOL * np.abs(a).max())
    for path, w in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = path[-1].key
        if key == "kernel":
            fan_in = (w.shape[-2] if name == "local_conv"
                      else math.prod(w.shape[:-1]))
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(np.abs(w).max()) <= 2 * std * (1 + 1e-6), path
        else:
            assert (w == (key == "scale")).all(), path
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(tree),
        jax.tree.leaves(seeded_params(flax_shapes(tf()), seed=5))))


def test_local_conv_init_uses_the_per_location_fan_in():
    """Each location's kernel is a lecun normal over kh kw C (not over the
    whole 4-D shape, which would shrink it by the number of locations);
    the bias starts at zero."""
    net = tnets.LocalConv2d(8, (3, 3), (40, 40), 4, seed=1)
    w = net.kernel.detach()
    assert w.shape == (38, 38, 36, 8) and not net.bias.detach().any()
    std = math.sqrt(1.0 / 36)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6)
    assert abs(float(w.std()) / std - 1) < 0.05
    with pytest.raises(ValueError, match="in_size"):
        net(torch.zeros(1, 32, 32, 4))


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
