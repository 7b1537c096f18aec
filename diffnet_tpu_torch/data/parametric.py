"""Parametric (ensemble) datasets, channels-last numpy (port of
``diffnet_tpu/data/parametric.py``).

Point-cloud samples are ``(cloud[Np, 5], forcing[H, W, 1], sink[H, W,
1])``, the cloud stacking (x, y, nx, ny, area); image samples are
``(inputs[H, W, C], forcing[H, W, 1])``.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.geometry import sample_ellipse_cloud

__all__ = ["ImageIMBack", "ImageIMBackObject", "ImageIMBackNeumann",
           "KLSumStochastic", "PointClouds", "SyntheticPointClouds"]


def _load_dir_images(dirname):
    """Every image of a directory, in sorted order, as a binary mask;
    decoded on a thread pool (PIL releases the GIL in file and codec
    work)."""
    from concurrent.futures import ThreadPoolExecutor

    import PIL.Image

    paths = []
    for fname in sorted(os.listdir(dirname)):
        path = os.path.join(dirname, fname)
        ext = os.path.splitext(path)[1]
        if ext not in (".png", ".jpg", ".bmp", ".tiff"):
            raise ValueError("invalid extension; extension not supported")
        paths.append(path)

    def decode(path):
        img = PIL.Image.open(path).convert("L")
        return (np.asarray(img) > 0).astype(float)

    if len(paths) < 2:
        return [decode(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(decode, paths))


class _ImageEnsembleBase:
    forcing_value = 0.0

    def __init__(self, dirname, domain_size=64):
        self.samples = [self._make_sample(img)
                        for img in _load_dir_images(dirname)]
        self.n_samples = len(self.samples)

    def _make_sample(self, img):
        domain = 1 - img
        bc1 = np.zeros_like(domain)
        bc1[(1 - domain).astype(bool)] = 1
        bc2 = np.zeros_like(domain)
        bc2[:, [0, -1]] = 1
        bc2[[0, -1], :] = 1
        return np.stack([domain, bc1, bc2], axis=-1).astype(np.float32)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        inputs = self.samples[idx]
        forcing = np.full(inputs.shape[:-1] + (1,), self.forcing_value,
                          np.float32)
        return inputs, forcing


class ImageIMBack(_ImageEnsembleBase):
    """A directory of binary images -> chi ensembles (domain, object,
    outer walls), zero forcing."""


class ImageIMBackObject(_ImageEnsembleBase):
    """The same with unit forcing."""

    forcing_value = 1.0


class ImageIMBackNeumann(_ImageEnsembleBase):
    """Neumann variant: bc2 = left and top walls (Dirichlet 1), bc3 = right
    and bottom (Dirichlet 0); 4 input channels."""

    def _make_sample(self, img):
        domain = 1 - img
        bc1 = np.zeros_like(domain)
        bc1[(1 - domain).astype(bool)] = 1
        bc2 = np.zeros_like(domain)
        bc2[:, 0] = 1
        bc2[0, :] = 1
        bc3 = np.zeros_like(domain)
        bc3[-1, :] = 1
        bc3[:, -1] = 1
        return np.stack([domain, bc1, bc2, bc3], axis=-1).astype(np.float32)


class KLSumStochastic:
    """Karhunen-Loeve coefficient samples (an ``.npy`` file or an array
    ``[N, k]``) as a dataset of diffusivity fields: ``inputs[n, n, 3]`` =
    (nu = exp(KL sum), bc1 on the left wall, bc2 on the right), zero
    forcing. The fields are made at construction, in one pass of the host
    library over the whole table (:func:`~diffnet_tpu_torch.utils.native.
    kl_diffusivity_batch`)."""

    def __init__(self, filename_or_coeffs, domain_size=64, kl_terms=6):
        from ..utils.native import kl_diffusivity_batch

        if isinstance(filename_or_coeffs, (str, os.PathLike)):
            coeffs = np.load(filename_or_coeffs)
        else:
            coeffs = np.asarray(filename_or_coeffs)
        self.coeffs = coeffs
        self.domain_size = n = domain_size
        self.kl_terms = kl_terms
        fields = kl_diffusivity_batch(coeffs, n, n_sum_nu=kl_terms)
        self.dataset = np.zeros((len(fields), n, n, 3), np.float32)
        self.dataset[..., 0] = fields
        self.dataset[:, :, 0, 1] = 1.0     # bc1: the left wall
        self.dataset[:, :, -1, 2] = 1.0    # bc2: the right wall
        self.n_samples = len(self.dataset)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        inputs = self.dataset[idx]
        forcing = np.zeros(inputs.shape[:-1] + (1,), np.float32)
        return inputs, forcing


class PointClouds:
    """Point-cloud ensemble from npz archives (``point_cloud.npz`` and
    ``normals.npz``, key ``arr_0``): the clouds are scaled into the domain,
    arc-length areas computed, and the first 1,250 clouds are the ``val``
    split, the rest ``train``."""

    def __init__(self, data_path, split="train", domain_size=32):
        points = np.load(os.path.join(data_path, "point_cloud.npz"))["arr_0"]
        normals = np.load(os.path.join(data_path, "normals.npz"))["arr_0"]
        if split == "val":
            points, normals = points[:1250], normals[:1250]
        else:
            points, normals = points[1250:], normals[1250:]
        points = points.astype(np.float64) * 0.5
        points[:, :, 0] += 0.25
        points[:, :, 1] += 0.5
        self._finish(points[:, :, :2], normals[:, :, :2], domain_size)

    def _finish(self, points, normals, domain_size):
        self.pc = points.astype(np.float32)
        self.normals = normals.astype(np.float32)
        # arc-length weights: half the Euclidean distance to each neighbour
        d_next = np.linalg.norm(np.roll(points, -1, 1) - points, axis=-1)
        d_prev = np.roll(d_next, 1, 1)
        self.area = (0.5 * (d_next + d_prev)).astype(np.float32)
        nd = self.domain_size = domain_size
        self.bc2 = np.zeros((nd, nd), np.float32)
        self.bc2[[0, -1], :] = 1
        self.bc2[:, [0, -1]] = 1
        self.n_samples = len(self.pc)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        cloud = np.concatenate(
            [self.pc[idx], self.normals[idx], self.area[idx][:, None]],
            axis=-1).astype(np.float32)
        nd = self.domain_size
        forcing = np.zeros((nd, nd, 1), np.float32)
        return cloud, forcing, self.bc2[..., None]


class SyntheticPointClouds(PointClouds):
    """Random ellipse boundary clouds, made from `seed`."""

    def __init__(self, n_samples=64, n_points=120, domain_size=32, seed=0):
        rng = np.random.default_rng(seed)
        pts, nrms = [], []
        for _ in range(n_samples):
            c = rng.uniform(0.35, 0.65, size=2)
            r = rng.uniform(0.08, 0.22, size=2)
            ang = rng.uniform(0, np.pi)
            p, nr, _ = sample_ellipse_cloud(n_points, center=c, radii=r,
                                            angle=ang)
            pts.append(p)
            nrms.append(nr)
        self._finish(np.stack(pts), np.stack(nrms), domain_size)
