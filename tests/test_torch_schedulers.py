"""The port's flow UniPC scheduler against ``blade.schedulers.unipc_flow``.

The schedule tables are copied numpy and must match exactly.  The step
math runs in f32 on both sides on the same numpy states and velocities;
coefficients are computed host-side in the port (numpy f32) and in jnp f32
in the reference, so states agree to 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from blade.schedulers import unipc_flow as J
from blade_torch.schedulers import unipc_flow as T


@pytest.mark.parametrize("steps,shift", [(8, 3.0), (4, 5.0), (1, 3.0)])
def test_schedule_tables_match(steps, shift):
    js = J.make_flow_unipc_schedule(steps, flow_shift=shift)
    ts = T.make_flow_unipc_schedule(steps, flow_shift=shift)
    for name in ("sigmas", "timesteps", "lambdas"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


@pytest.mark.parametrize("steps", [8, 3])
def test_unipc_steps_match_reference(steps):
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((1, 4, 3, 6, 8)).astype(np.float32)
    js = J.make_flow_unipc_schedule(steps)
    ts = T.make_flow_unipc_schedule(steps)
    jstate, tstate = J.unipc_init(x), T.unipc_init(torch.from_numpy(x))
    for i in range(steps):
        v = rng.standard_normal(x.shape).astype(np.float32)
        jstate = J.unipc_step(js, jstate, v, i)
        tstate = T.unipc_step(ts, tstate, torch.from_numpy(v), i)
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_euler_step_matches_reference():
    rng = np.random.default_rng(0)
    x, v = rng.standard_normal((2, 1, 4, 5)).astype(np.float32)
    s = J.make_flow_unipc_schedule(8)
    got = T.euler_step(T.make_flow_unipc_schedule(8), torch.from_numpy(x),
                       torch.from_numpy(v), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(J.euler_step(s, x, v, 2)),
                               rtol=1e-6, atol=1e-6)
