"""The port's plain multi-level attention (the plain version of
``bt_multilevel_fwd`` in ``csrc/gather_attn.cu``) against JAX's fused
multi-level Pallas kernel in interpret mode, on the same f32 inputs and
per-level lists: ragged lengths (edge-padded pyramid, pooled tail
masking), the forced last two rows, one empty row, both of JAX's pooled
lanes (the single-shot merged tile and the per-level loops), q_rows 128
and 256, d 64 and 128.
Tolerance 1e-5 (f32 online softmax against a masked dense softmax).
Each configuration costs ~30 s of Pallas interpret compilation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention import masks as JM
from blade.attention.asa import _fused_lane_params
from blade.kernels.multilevel_attn import multilevel_attention as j_multilevel
from blade_torch.kernels.multilevel_attn import multilevel_attention as t_multilevel
from blade_torch.kernels.ref_attention import NEG_INF

RATIOS = {1: (0.0, 0.25), 2: (0.25, 0.5), 4: (0.5, 0.75), 8: (0.75, 0.9), 0: (0.9, 1.0)}


@pytest.mark.parametrize("l,d,q_rows,single_shot", [
    (900, 64, 128, True),
    (1100, 128, 256, False),
])
def test_plain_multilevel_matches_jax_fused(l, d, q_rows, single_shot):
    rng = np.random.default_rng(l + d)
    q, k, v = (rng.standard_normal((1, 2, l, d)).astype(np.float32) for _ in range(3))
    n_kt, n_q = -(-l // 128), -(-l // q_rows)
    scores = rng.random((1, 2, n_q, n_kt)).astype(np.float32)
    cap, tiles, fits = _fused_lane_params(l, RATIOS)
    idx, cnt = JM.multilevel_lists(jnp.asarray(scores), RATIOS, cap=cap)
    cnt = cnt.at[0, 1, 1].set(0)  # one empty row
    assert fits or not single_shot
    j_out, j_lse = j_multilevel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, lists=(idx, cnt),
        interpret=True, fused=True, q_rows=q_rows,
        pooled_tiles=tiles if single_shot else None, pooled_single_shot=single_shot)
    t_out, t_lse = t_multilevel(
        *(torch.from_numpy(x) for x in (q, k, v)),
        lists=(torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(cnt))),
        q_rows=q_rows)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5, rtol=1e-5)
    rows = slice(q_rows, 2 * q_rows)
    assert t_out[0, 1, rows].abs().max().item() == 0.0
    assert (t_lse[0, 1, rows] == NEG_INF).all()
