"""convert.graph_from_arrays / graph_to_arrays round trips."""

import numpy as np

from torch_port_helpers import jax_graph_to_arrays

import incrementalinference_torch as it


def test_round_trip_through_arrays():
    fg = it.generate_line_step(8, graphinit=True, device="cpu")
    spec = it.graph_to_arrays(fg)
    back = it.graph_from_arrays(spec, device="cpu")
    assert back.ls() == fg.ls() and back.lsf() == fg.lsf()
    for f in fg.lsf():
        assert back.factor(f).variables == fg.factor(f).variables
        assert type(back.factor(f).model) is type(fg.factor(f).model)
        assert float(back.factor(f).model.Z.mu) == float(
            fg.factor(f).model.Z.mu)
    for v in fg.ls():
        b0, b1 = fg.get_belief(v), back.get_belief(v)
        np.testing.assert_array_equal(b1.points.numpy(), b0.points.numpy())
        np.testing.assert_array_equal(b1.bw.numpy(), b0.bw.numpy())
        np.testing.assert_array_equal(b1.ipc.numpy(), b0.ipc.numpy())
    again = it.graph_to_arrays(back)
    assert again["params"] == spec["params"]
    # auto-named factors continue the numbering instead of colliding
    back.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)), graphinit=False)


def test_jax_graph_carries_across():
    from incrementalinference.jl_tpu import canonical as jcan

    fj = jcan.generate_line_step(4, graphinit=True)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
    assert ft.ls() == fj.ls() and ft.lsf() == fj.lsf()
    for v in fj.ls():
        np.testing.assert_array_equal(ft.points(v).numpy(),
                                      np.asarray(fj.points(v)))
        np.testing.assert_array_equal(ft.get_belief(v).bw.numpy(),
                                      np.asarray(fj.get_belief(v).bw))
