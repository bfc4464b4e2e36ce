"""The port's small core helpers against the JAX package's:
``core/cameras.py::focal_to_fov``, ``core/transforms.py::strip_symmetric``
and ``unpack_symmetric``, ``core/sh.py::sh_to_rgb``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch.core import cameras as pcams
from priordepth_gaussiansplatting_torch.core import sh as psh
from priordepth_gaussiansplatting_torch.core import transforms as ptf
from priordepth_gaussiansplatting_tpu.core import cameras as jcams
from priordepth_gaussiansplatting_tpu.core import sh as jsh
from priordepth_gaussiansplatting_tpu.core import transforms as jtf

torch.set_num_threads(2)


@pytest.mark.parametrize("focal,pixels", [(50.0, 64), (1111.0, 1600),
                                          (0.82 * 512, 512)])
def test_focal_to_fov(focal, pixels):
    fov = pcams.focal_to_fov(focal, pixels)
    assert fov == jcams.focal_to_fov(focal, pixels)
    assert pcams.fov_to_focal(fov, pixels) == pytest.approx(focal,
                                                            rel=1e-12)
    assert 0 < fov < math.pi


def test_strip_and_unpack_symmetric():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 7, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)
    got = ptf.strip_symmetric(torch.from_numpy(cov)).numpy()
    want = np.asarray(jtf.strip_symmetric(jnp.asarray(cov)))
    assert got.shape == (5, 7, 6)
    np.testing.assert_array_equal(got, want)
    back = ptf.unpack_symmetric(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jtf.unpack_symmetric(jnp.asarray(want))))
    np.testing.assert_array_equal(back, cov)


def test_sh_to_rgb():
    rng = np.random.default_rng(1)
    sh = rng.standard_normal((64, 3)).astype(np.float32)
    got = psh.sh_to_rgb(torch.from_numpy(sh)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsh.sh_to_rgb(
        jnp.asarray(sh))))
    np.testing.assert_allclose(psh.rgb_to_sh(psh.sh_to_rgb(sh)), sh,
                               rtol=1e-6, atol=1e-6)
