"""The monocular initializer's essential decomposition against the JAX
package's, bit for bit.

The JAX initializer forms E = K^T F K and decomposes it with eager jnp ops
on the CPU (`stella_vslam_tpu/module/initializer.py:245-246`,
`ops/solve/essential.py:182`): each 3x3 product an XLA dot (an FMA chain
over k), jnp.linalg.svd LAPACK's sgesdd, t's norm an FMA chain with a
correctly rounded root. The port took both in float64 numpy, which moved
the loop world's init rotation by 1e-4 degrees and its closed-loop ATE from
JAX's 16.94 mm to 33.09 mm (`scripts/torch_distorted_parity.py --leg
loop_world`); in float32 in that rounding it initializes as JAX does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops.solve import essential as jE
from stella_vslam_tpu_torch.ops import linalg as tl
from stella_vslam_tpu_torch.ops.solve import essential as tE

torch.set_num_threads(1)

K = np.array([[320.0, 0.0, 200.0], [0.0, 320.0, 150.0], [0.0, 0.0, 1.0]], np.float32)


def _apart(j, t) -> int:
    return int(np.sum(np.asarray(j).view(np.int32) != t.numpy().view(np.int32)))


@pytest.mark.parametrize("scale", [1e-6, 1e-4, 1.0])
def test_essential_decomposition_equals_jax_eager(scale):
    rng = np.random.default_rng(int(-np.log10(scale)))
    Kt = torch.from_numpy(K)
    apart = {"E": 0, "R": 0, "t": 0}
    for _ in range(100):
        F = (rng.standard_normal((3, 3)) * scale).astype(np.float32)
        Ej = jnp.asarray(K.T) @ jnp.asarray(F) @ jnp.asarray(K)
        Et = tl.matmul_f32(tl.matmul_f32(Kt.T.contiguous(), torch.from_numpy(F)), Kt)
        apart["E"] += _apart(Ej, Et)
        Rj, tj = jE.decompose(Ej)
        Rt, tt = tE.decompose(Et)
        assert Rt.dtype == tt.dtype == torch.float32
        apart["R"] += _apart(Rj, Rt)
        apart["t"] += _apart(tj, tt)
    assert apart == {"E": 0, "R": 0, "t": 0}
