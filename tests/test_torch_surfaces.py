"""The graph and tree surfaces of the port on the CPU: the cases of
tests/test_accessors.py, tests/test_tree_functions.py,
tests/test_generic_api.py, tests/test_graph_ops.py and
tests/test_native.py:26-32 on the port, and, where the result is
deterministic, the same call of both packages on the same graph (carried
over by convert.py) compared: orders label for label, trees clique for
clique, numbers to a stated tolerance."""

import copy

import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_graph_to_arrays,
                                jax_native_ordering_available, rng, t)

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu.parallel import messages as jmsg
from incrementalinference.jl_tpu.parallel.scheduler import \
    build_clique_subgraph as jl_subgraph
from incrementalinference.jl_tpu.tree import analysis as jan
from incrementalinference_torch.convert import graph_from_arrays
from incrementalinference_torch.parallel import messages as tmsg
from incrementalinference_torch.parallel.scheduler import \
    build_clique_subgraph
from incrementalinference_torch.tree import analysis as tan


def _chain(n=3, graphinit=True):
    """tests/test_accessors.py's chain on the port."""
    fg = it.initfg(it.SolverParams(N=50, graphinit=graphinit), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.5)))
    for i in range(1, n):
        fg.add_variable(f"x{i}", it.ContinuousScalar)
        fg.add_factor([f"x{i - 1}", f"x{i}"],
                      it.LinearRelative(it.Normal(10.0, 0.5)))
    return fg


def _carried(gj):
    """A JAX-package graph on the port, the same labels and factor order."""
    return graph_from_arrays(jax_graph_to_arrays(gj), device="cpu")


# -- fgos: basic accessors ----------------------------------------------------

def test_get_list_variables_factors():
    fg = _chain()
    assert it.get_variable(fg, "x1") is fg.var("x1")
    fl = fg.lsf()[0]
    assert it.get_factor(fg, fl) is fg.factor(fl)
    assert it.list_variables(fg) == ["x0", "x1", "x2"]
    assert it.list_variables(fg, regex=r"x[12]") == ["x1", "x2"]
    assert len(it.list_factors(fg)) == 3
    assert it.is_variable(fg, "x0") and not it.is_variable(fg, fl)
    assert it.is_factor(fg, fl) and not it.is_factor(fg, "x0")
    assert it.get_label(fg.var("x0")) == "x0"
    assert it.get_variable_type(fg, "x0") == it.ContinuousScalar
    assert it.get_variable_dim(fg, "x0") == 1
    assert it.get_dimension(fg.var("x0")) == 1
    assert isinstance(it.get_factor_type(fg, fl), it.Prior)
    assert it.get_factor_dim(fg, fl) == 1
    assert it.get_timestamp(fg, "x0") > 0
    assert it.get_timestamp(fg, fl) >= it.get_timestamp(fg, "x0")
    assert fg.neighbors("x1") == fg.factors_of("x1")
    assert fg.neighbors(fl) == ["x0"]


def test_listings_match_jax_on_the_same_graph():
    """Label listings, neighbourhoods and groupings of both packages on
    one graph: equal, label for label."""
    gj = jl.canonical.generate_line_step(12, graphinit=False)
    gt = _carried(gj)
    for fn in ("list_variables", "list_factors", "lsf_priors",
               "get_variable_order", "ls_types", "lsf_types"):
        assert getattr(it, fn)(gt) == getattr(jl, fn)(gj), fn
    for v in gj.ls():
        assert it.ls2(gt, v) == jl.ls2(gj, v)
        assert gt.neighbors(v) == gj.neighbors(v)
    for fl in gj.lsf():
        assert gt.neighbors(fl) == gj.neighbors(fl)
    for vs in (["x0", "x2"], ["x2", "x4", "lm4"], gj.ls()):
        assert (it.get_factors_among_variables_only(gt, vs, unused=False)
                == jl.get_factors_among_variables_only(gj, vs, unused=False))
        assert (it.find_factors_between_from(gt, vs, vs[0])
                == jl.find_factors_between_from(gj, vs, vs[0]))
    assert it.sort_dfg(["x10", "l2", "x2", "x1"]) == jl.sort_dfg(
        ["x10", "l2", "x2", "x1"])
    assert (it.list_variables(gt, regex=r"^l", solvable=1)
            == jl.list_variables(gj, regex=r"^l", solvable=1))


def test_solvable_and_tags():
    fg = _chain()
    assert it.get_solvable(fg, "x0") == 1
    it.set_solvable(fg, "x0", 0)
    assert it.get_solvable(fg, "x0") == 0
    assert it.list_variables(fg, solvable=1) == ["x1", "x2"]
    fg.var("x1").tags.add("POSE")
    assert "POSE" in it.get_tags(fg, "x1")


def test_val_bw_numpts():
    fg = _chain()
    assert it.get_val(fg, "x1").shape == (50, 1)
    assert it.get_num_pts(fg, "x1") == 50
    it.set_val(fg, "x1", np.full((50, 1), 7.0))
    assert abs(float(it.get_val(fg, "x1").mean()) - 7.0) < 1e-6
    bw = it.get_bw(fg, "x1")
    it.set_bw(fg, "x1", bw.numpy() * 2.0)
    assert np.allclose(it.get_bw(fg, "x1").numpy(), bw.numpy() * 2.0)


def test_ppe_accessors_and_find_near():
    fg = _chain()
    it.solve_tree(fg)
    for lbl in fg.ls():
        assert "suggested" in it.get_variable_ppe(fg, lbl)
    assert abs(float(it.get_ppe_mean(fg, "x2")) - 20.0) < 2.0
    assert "default" in it.get_ppe_dict(fg, "x2")
    labels, mat = it.get_ppe_suggested_all(fg)
    assert labels == ["x0", "x1", "x2"] and mat.shape == (3, 1)
    near, dists = it.find_variables_near(fg, [9.5], number=1)
    assert near == ["x1"] and dists[0] < 2.0
    est = it.calc_variable_ppe(fg, "x1")
    assert abs(float(est["mean"]) - float(it.get_ppe_mean(fg, "x1"))) < 1e-4
    assert float(it.get_ppe_max(fg, "x1")) == float(
        it.get_ppe_suggested(fg, "x1"))


def test_ppe_of_carried_beliefs_matches_jax():
    """calc_variable_ppe, get_ppe_suggested_all and find_variables_near on
    beliefs carried from a JAX solve: 1e-5 (mean) and 1e-4 (max)."""
    gj = jl.initfg(jl.SolverParams(N=50))
    gj.add_variable("x0", jl.ContinuousScalar)
    gj.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 0.5)))
    for i in (1, 2):
        gj.add_variable(f"x{i}", jl.ContinuousScalar)
        gj.add_factor([f"x{i - 1}", f"x{i}"],
                      jl.LinearRelative(jl.Normal(10.0, 0.5)))
    gt = _carried(gj)
    for v in gj.ls():
        pj = jl.calc_variable_ppe(gj, v)
        pt = it.calc_variable_ppe(gt, v)
        np.testing.assert_allclose(pt["mean"].numpy(), np.asarray(pj["mean"]),
                                   atol=1e-5)
        np.testing.assert_allclose(pt["max"].numpy(), np.asarray(pj["max"]),
                                   atol=1e-4)
        gt.var(v).ppe["default"] = pt
        gj.var(v).ppe["default"] = pj
    lt, mt = it.get_ppe_suggested_all(gt)
    lj, mj = jl.get_ppe_suggested_all(gj)
    assert lt == lj
    np.testing.assert_allclose(mt, mj, atol=1e-4)
    assert (it.find_variables_near(gt, [11.0], number=2)[0]
            == jl.find_variables_near(gj, [11.0], number=2)[0])


def test_solver_data_mutation_and_solvekeys():
    fg = _chain()
    it.solve_tree(fg)
    it.set_solved_count(fg, "x0", 5)
    assert fg.var("x0").get_solved_count() == 5
    it.set_marginalized(fg, "x0", True)
    assert it.is_marginalized(fg, "x0")
    assert it.unfreeze_variables_all(fg) == ["x0"]
    assert not it.is_marginalized(fg, "x0")
    assert "default" in it.list_solve_keys(fg)
    assert set(it.clone_solve_key(fg, "backup", "default")) == {"x0", "x1",
                                                                 "x2"}
    assert "backup" in it.list_supersolves(fg, "x1")
    it.delete_variable_solver_data(fg, "x1", "backup")
    assert "backup" not in it.list_solve_keys(fg, "x1")
    it.set_variable_initialized(fg, "x0", False)
    assert not fg.var("x0").is_initialized()
    it.set_variable_infer_dim(fg, "x0", 0.25)
    assert np.allclose(fg.get_belief("x0").ipc.numpy(), 0.25)
    it.reset_variable(fg, "x0")
    assert "default" not in fg.var("x0").beliefs
    it.set_variable_reference(fg, "x0", np.zeros((50, 1)))
    assert "reference" in it.list_solve_keys(fg, "x0")
    assert it.reset_variable_all_initializations(fg) == fg.ls()
    assert not any(fg.var(v).is_initialized() for v in fg.ls())
    fg.params = fg.params.replace(is_fixed_lag=True)
    it.set_marginalized(fg, "x1", True)
    assert it.dont_marginalize_variables_all(fg) == ["x1"]
    assert not fg.params.is_fixed_lag


def test_copy_graph_and_sort():
    fg = _chain()
    full = it.deepcopy_graph(fg)
    assert full.ls() == fg.ls() and full.lsf() == fg.lsf()
    full.remove_variable("x2")
    assert "x2" in fg.ls() and fg.factors_of("x1") == [
        fl for fl in fg.lsf() if "x1" in fg.factor(fl).variables]
    sub = it.copy_graph(fg, ["x0", "x1"])
    assert sub.ls() == ["x0", "x1"] and len(sub.lsf()) == 2
    with pytest.raises(ValueError):
        it.copy_graph(fg, ["x0"], factors=fg.factors_of("x1"))
    assert it.sort_dfg(["x10", "x2", "x1"]) == ["x1", "x2", "x10"]
    assert it.get_variable_order(fg) == ["x0", "x1", "x2"]


def test_find_factors_between_and_among():
    fg = _chain(4)
    between = it.find_factors_between_from(fg, ["x0", "x1"], "x0")
    models = [type(fg.factor(f).model).__name__ for f in between]
    assert sorted(models) == ["LinearRelative", "Prior"]
    assert len(it.get_factors_among_variables_only(fg, ["x1", "x2"],
                                                   unused=False)) == 1
    it.build_tree(fg)
    assert it.get_factors_among_variables_only(fg, ["x1", "x2"]) == []


def test_find_closest_timestamp():
    fg = _chain()
    ts = it.get_timestamp(fg, "x1")
    assert it.find_closest_timestamp(fg, ts, labels=fg.ls()) == "x1"


def test_measurements_and_deconv_solve_key():
    fg = _chain()
    it.solve_tree(fg)
    fl = [f for f in fg.lsf() if len(fg.factor(f).variables) == 2][0]
    z = it.get_measurements(fg, fl, n=30).numpy()
    assert z.shape[0] == 30 and abs(z.mean() - 10.0) < 1.0
    it.clone_solve_key(fg, "shifted", "default")
    solved, _ = it.deconv_solve_key(fg, "x0", "default", "x1", "default")
    assert abs(float(solved.mean()) - 10.0) < 2.5


def test_numeric_helpers_against_jax():
    """fastnorm, reshape_vec2mat and cont2disc: the double integrator's
    known answer, and equal to the JAX package's (1e-12)."""
    assert abs(it.fastnorm([3.0, 4.0]) - 5.0) < 1e-12
    m = it.reshape_vec2mat([1, 2, 3, 4, 5, 6], 2)
    assert m.shape == (2, 3) and m[0, 0] == 1 and m[1, 0] == 2
    np.testing.assert_array_equal(m, jl.reshape_vec2mat([1, 2, 3, 4, 5, 6],
                                                        2))
    F = [[0.0, 1.0], [0.0, 0.0]]
    G = [[0.0], [1.0]]
    dt = 0.5
    Phi, Gamma, Qd = it.fgos.cont2disc(F, G, [[1.0]], dt)
    assert np.allclose(Phi, [[1.0, dt], [0.0, 1.0]])
    assert np.allclose(Gamma, [[dt * dt / 2], [dt]], atol=1e-12)
    assert np.allclose(Qd, [[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]],
                       atol=1e-10)
    r = rng(1)
    F = r.normal(size=(3, 3))
    G = r.normal(size=(3, 2))
    Qc = np.eye(2) * 0.3
    for a, b in zip(it.fgos.cont2disc(F, G, Qc, 0.1),
                    jl.fgos.cont2disc(F, G, Qc, 0.1)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_printers():
    fg = _chain()
    it.solve_tree(fg)
    s = it.fgos.print_variable(fg, "x0", short=False)
    assert "x0" in s and "solveKey" in s and "ppe.suggested" in s
    assert "Prior" in it.fgos.print_factor(fg, fg.lsf()[0])
    assert "3 variables" in it.fgos.print_graph_summary(fg)


# -- tree accessors -----------------------------------------------------------

def _solved_tree():
    fg = _chain(4)
    return fg, it.solve_tree(fg)


def test_clique_lookup_and_topology():
    fg, tree = _solved_tree()
    root = tree.clique(tree.root_ids[0])
    assert it.get_clique(tree, root.frontals[0]) is root
    assert it.get_clique(tree, root.cid) is root
    assert it.get_clique_data(tree, root.cid) is root
    assert it.get_num_cliqs(tree) == tree.num_cliques()
    assert set(it.get_clique_ids(tree)) == set(tree.cliques)
    assert it.get_cliques(tree) is tree.cliques
    assert it.has_clique(tree, root.frontals[0])
    assert it.get_parent(tree, root) is None
    assert it.parent_cliq(tree, root) == []
    kids = it.get_children(tree, root)
    assert kids == it.child_cliqs(tree, root)
    assert kids
    assert it.get_cliq_depth(tree, kids[0]) == 1
    assert it.get_parent(tree, kids[0]) is root
    assert kids[0] in it.get_cliq_siblings(tree, kids[0], inclusive=True)
    assert kids[0] not in it.get_cliq_siblings(tree, kids[0])
    assert it.get_frontals(root) == root.frontals
    assert tree.is_root(root.cid) and not tree.is_root(kids[0].cid)


def test_clique_contents_and_matrices():
    fg, tree = _solved_tree()
    root = tree.clique(tree.root_ids[0])
    assert it.get_cliq_frontal_var_ids(root) == root.frontals
    assert it.get_cliq_separator_var_ids(root) == root.separator
    assert it.get_cliq_all_var_ids(root) == root.frontals + root.separator
    assert it.get_cliq_var_ids_all(root) == root.all_vars
    assert it.get_cliq_factor_ids_all(root) == root.potentials
    assert it.get_clique_potentials(root) == root.potentials
    assert all(f.label in root.potentials
               for f in it.get_cliq_factors(fg, root))
    assert (it.get_cliq_var_ids_priors(fg, root)
            == it.get_cliq_var_singletons(fg, root))
    A = it.get_cliq_assoc_mat(fg, tree, root.cid)
    M = it.get_cliq_msg_mat(fg, tree, root.cid)
    full = it.get_cliq_mat(fg, tree, root.cid)
    assert A.shape[0] + M.shape[0] == full.shape[0]
    assert A.shape[1] == len(root.all_vars)
    counts = it.get_cliq_num_assoc_factors_per_var(fg, tree, root.cid)
    assert counts.shape == (len(root.all_vars),)


def test_clique_status_predicates_and_color():
    fg, tree = _solved_tree()
    root = tree.clique(tree.root_ids[0])
    assert it.get_clique_status(root) == it.CliqStatus.DOWNSOLVED
    assert it.get_cliq_status(root) == it.CliqStatus.DOWNSOLVED
    assert it.is_cliq_initialized(root) and it.is_cliq_up_solved(root)
    assert it.is_tree_solved(tree) and it.is_up_inference_complete(tree)
    assert it.are_cliq_variables_all_initialized(fg, root)
    assert not it.are_cliq_variables_all_marginalized(fg, root)
    assert it.get_clique_draw_color(root) == "lightgreen"
    it.set_clique_draw_color(root, "pink")
    assert it.get_clique_draw_color(root) == "pink"
    it.set_clique_status(root, it.CliqStatus.NULL)
    assert not it.is_tree_solved(tree)
    assert it.are_siblings_remaining_need_down_only(tree, root.cid)


def test_tree_edits_resets_recycle_stats():
    fg, tree = _solved_tree()
    root = tree.clique(tree.root_ids[0])
    extra = [v for v in fg.ls() if v not in root.all_vars]
    assert extra
    it.append_separator_to_clique(tree, root.cid, [extra[0]])
    assert extra[0] in root.separator
    assert sorted(it.get_tree_all_frontal_syms(tree)) == sorted(fg.ls())
    assert set(it.get_cliq_var_solve_order_up(fg, root)) <= set(
        root.all_vars)
    total, marg, reused, both = it.calc_cliques_recycled(tree)
    assert total == tree.num_cliques()
    it.reset_cliq_solve(fg, tree, root.cid)
    assert root.status == it.CliqStatus.NULL
    assert all(not fg.var(v).is_initialized() for v in root.frontals)
    it.reset_tree_cliques_for_up_solve(tree)
    assert all(c.status == it.CliqStatus.NULL for c in tree.cliques.values())
    for fl in fg.lsf():
        fg.factor(fl).potential_used = True
        it.reset_data(fg.factor(fl))
        assert not fg.factor(fl).potential_used


def test_up_msg_introspection_and_tree_product():
    fg, tree = _solved_tree()
    assert set(it.get_tree_cliq_up_msgs_all(tree)) == set(tree.cliques)
    for entries in it.stack_cliq_up_msgs_by_variable(tree).values():
        assert all("belief" in e and "cliqId" in e for e in entries)
    root = tree.clique(tree.root_ids[0])
    var = root.frontals[0]
    b = it.tree_product_up(fg, tree, var, var)
    assert abs(float(b.points.mean()) - float(fg.points(var).mean())) < 3.0
    b2 = it.tree_product_down(fg, tree, var, var)
    assert b2.points.shape == b.points.shape
    sent = it.get_cliq_down_msgs_after_down_solve(tree, root.cid)
    assert set(sent) == set(root.children)


def _trees(order, gj=None):
    """The same graph and the same elimination order in both packages."""
    gj = gj or jl.canonical.generate_line_step(
        12, landmark_priors_at=(0, 8), graphinit=False)
    gt = _carried(gj)
    order = order or jl.get_elimination_order(gj, "qr")
    return gj, gt, jl.build_tree(gj, order=order), it.build_tree(gt,
                                                                  order=order)


def test_tree_accessors_match_jax_clique_for_clique():
    """On one graph and one order, each clique's contents, depth, priors,
    association matrices, solve orders and the tree's costs equal the JAX
    package's."""
    gj, gt, tj, tt = _trees(None)
    assert set(tj.cliques) == set(tt.cliques)
    assert it.get_tree_all_frontal_syms(tt) == jl.get_tree_all_frontal_syms(
        tj)
    for cid, cj in tj.cliques.items():
        ct = tt.clique(cid)
        assert (ct.frontals, ct.separator, ct.potentials, ct.parent) == (
            cj.frontals, cj.separator, cj.potentials, cj.parent)
        assert tt.is_root(cid) == tj.is_root(cid)
        assert it.get_cliq_depth(tt, ct) == jl.get_cliq_depth(tj, cj)
        assert [c.cid for c in it.get_cliq_siblings(tt, ct)] == [
            c.cid for c in jl.get_cliq_siblings(tj, cj)]
        assert (it.get_cliq_var_ids_priors(gt, ct)
                == jl.get_cliq_var_ids_priors(gj, cj))
        assert (it.get_cliq_var_solve_order_up(gt, ct)
                == jl.get_cliq_var_solve_order_up(gj, cj))
        for fn in ("get_cliq_assoc_mat", "get_cliq_msg_mat", "get_cliq_mat",
                   "get_cliq_num_assoc_factors_per_var"):
            np.testing.assert_array_equal(getattr(it, fn)(gt, tt, cid),
                                          getattr(jl, fn)(gj, tj, cid))
        dwn = list(cj.separator)
        assert (it.get_cliq_init_var_order_down(gt, tt, cid, dwn)
                == jl.get_cliq_init_var_order_down(gj, tj, cid, dwn))
        assert (it.get_cliq_vars_with_frontal_neighbors(gt, ct)
                == jl.get_cliq_vars_with_frontal_neighbors(gj, cj))
    for fn in ("nnz_tree", "tree_cost_01", "tree_cost_02"):
        assert getattr(tan, fn)(tt) == getattr(jan, fn)(tj), fn
    it.build_clique_potentials(gt, tt)
    jl.build_clique_potentials(gj, tj)
    for cid, cj in tj.cliques.items():
        ct = tt.clique(cid)
        assert (ct.potentials, ct.direct_vars, ct.iter_vars) == (
            cj.potentials, cj.direct_vars, cj.iter_vars)


def test_recycled_counts_match_jax():
    """build_tree_reset against the previous tree: calc_cliques_recycled
    equal to the JAX package's."""
    gj = jl.canonical.generate_line_step(
        8, graphinit=False, params=jl.SolverParams(incremental=True))
    gt = _carried(gj)
    oj = jl.build_tree(gj, order=gj.ls())
    ot = it.build_tree(gt, order=gt.ls())
    for tree, p in ((oj, jl), (ot, it)):      # as an up solve leaves them
        for c in tree.cliques.values():
            p.set_clique_status(c, p.CliqStatus.UPSOLVED)
    for g, p in ((gj, jl), (gt, it)):
        g.add_variable("x9", p.ContinuousScalar)
        g.add_factor(["x8", "x9"], p.LinearRelative(p.Normal(1.0, 0.1)),
                     graphinit=False, label="x8x9f")
    nj = jl.build_tree_reset(gj, order=gj.ls(), old_tree=oj)
    nt = it.build_tree_reset(gt, order=gt.ls(), old_tree=ot)
    assert it.calc_cliques_recycled(nt) == jl.calc_cliques_recycled(nj)
    assert it.calc_cliques_recycled(nt)[2] > 0


def test_analysis_against_jax():
    """nnz_sqrt_info_matrix, all_tree_costs over given orders, get_all_trees
    on the Kaess graph (120 orders) and shrink_factor_graph: equal."""
    gj = jl.canonical.generate_kaess()
    gt = _carried(gj)
    assert tan.nnz_sqrt_info_matrix(gt) == jan.nnz_sqrt_info_matrix(gj)
    orders = [["l1", "l2", "x1", "x2", "x3"], ["x3", "x2", "x1", "l2", "l1"]]
    for a, b in zip(tan.all_tree_costs(gt, orders),
                    jan.all_tree_costs(gj, orders)):
        assert a == b
    aj, at = jan.get_all_trees(gj), tan.get_all_trees(gt)
    assert len(at) == len(aj) == 120
    assert [v[2] for v in at.values()] == [v[2] for v in aj.values()]
    lj = jl.canonical.generate_line_step(12, pose_every=1, graphinit=False)
    sj, st = jan.shrink_factor_graph(lj, 4), tan.shrink_factor_graph(
        _carried(lj), 4)
    assert st.ls() == sj.ls() and st.lsf() == sj.lsf()
    with pytest.raises(ValueError):
        tan.get_all_trees(it.generate_line_step(20, pose_every=1,
                                                device="cpu"))


# -- the rest of tests/test_accessors.py --------------------------------------

def test_object_listings_and_solver_data():
    fg = _chain()
    it.solve_tree(fg)
    assert [v.label for v in it.get_variables(fg)] == fg.ls()
    assert [f.label for f in it.get_factors(fg)] == fg.lsf()
    sd = it.get_solver_data(fg, "x1")
    assert sd["initialized"] and sd["solved_count"] > 0
    assert sd["belief"] is fg.get_belief("x1")
    bw = it.get_bw_val(fg, "x1")
    assert bw.shape[-1] == 1 and np.all(bw > 0)


def test_point_identity_type_and_multihypo_dist():
    p = it.get_point_identity(it.Position2)
    assert np.allclose(p.numpy(), 0.0) and p.shape == (2,)
    shape, dtype = it.get_point_type(it.Position2)
    assert shape == (2,) and dtype == np.float32
    assert it.get_point_type(it.SE2())[0] == jl.get_point_type(jl.SE2())[0]
    fg = _chain()
    fg.add_variable("l1", it.ContinuousScalar)
    f = fg.add_factor(["x0", "x1", "l1"], it.LinearRelative(it.Normal(0, 1)),
                      multihypo=[1.0, 0.5, 0.5])
    d = it.get_multihypo_distribution(fg, f.label)
    assert np.allclose(d.p, [0.5, 0.25, 0.25])
    assert it.get_multihypo_distribution(fg, fg.lsf()[0]) is None


def test_logpath_type_listings_and_tree():
    fg = _chain()
    assert it.get_log_path(fg) == fg.params.logpath
    assert it.join_log_path(fg, "logs", 3).endswith("logs/3")
    assert it.ls_types(fg) == {"ContinuousEuclid1": ["x0", "x1", "x2"]}
    assert set(it.lsf_types(fg)) == {"Prior", "LinearRelative"}
    txt = it.list_type_tree()
    assert "FactorModel" in txt and "Prior" in txt
    wf = [c.__name__ for c in it.get_current_workspace_factors()]
    assert {"Prior", "LinearRelative", "Mixture", "DERelative",
            "PartialPriorPassThrough"} <= set(wf)
    wv = [v.name for v in it.get_current_workspace_variables()]
    assert "ContinuousEuclid1" in wv and "Circular" in wv
    assert "Position4" in wv


def test_solver_data_lifecycle():
    fg = _chain()
    assert it.make_solver_data(fg, "parametric_init") == fg.ls()
    assert "parametric_init" in it.list_solve_keys(fg, "x0")
    it.build_tree(fg)
    assert any(f.potential_used for f in fg.factors.values())
    it.reset_factor_graph_new_tree(fg)
    assert not any(f.potential_used for f in fg.factors.values())
    it.default_fixed_lag_on_tree(fg, qfl=2)
    assert fg.params.qfl == 2 and fg.params.is_fixed_lag
    it.init_variable_manual(fg, "x0", np.full((50, 1), 3.0))
    assert abs(float(fg.points("x0").mean()) - 3.0) < 1e-5
    it.set_val(fg, "x0", np.full((50, 1), 8.0))
    it.reset_init_values(fg)
    assert abs(float(fg.points("x0").mean())) < 1.0


def test_distribution_string_parsing_against_jax():
    n = it.normal_from_string("Normal(2.0, 0.5)")
    assert n.mu == 2.0 and n.sigma == 0.5
    c = it.categorical_from_string("Categorical([0.2, 0.8])")
    assert np.allclose(c.p, [0.2, 0.8])
    u = it.extract_distribution("Uniform(0.0, 2.0)")
    assert u.a == 0.0 and u.b == 2.0
    for s in ("MvNormal([0.0, 1.0], [1.0, 1.0])", "Rayleigh(1.5)",
              "Normal(-1, 3)"):
        dt, dj = it.extract_distribution(s), jl.extract_distribution(s)
        assert type(dt).__name__ == type(dj).__name__
        for a, b in zip(dt.mean_cov(), dj.mean_cov()):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        it.extract_distribution("Bogus(1)")


def test_position_aliases():
    for n, vt in enumerate((it.Position1, it.Position2, it.Position3,
                            it.Position4), 1):
        jt = getattr(jl, f"Position{n}")
        assert (vt.name, vt.manifold.dof) == (jt.name, jt.manifold.dof)


def test_preamble_cache_hook():
    calls = []

    class CachedPrior(it.Prior):
        def preamble_cache(self, fg, variables, factor):
            calls.append((factor.label, [v.label for v in variables]))
            return {"range_lookup": 42}

    fg = it.initfg(it.SolverParams(N=30), device="cpu")
    fg.add_variable("a", it.ContinuousScalar)
    f = fg.add_factor(["a"], CachedPrior(it.Normal(0, 1)), graphinit=False)
    assert f.cache == {"range_lookup": 42}
    assert calls == [(f.label, ["a"])]


def test_lsf_priors_and_compare_special():
    fg = _chain(3, graphinit=False)
    pri = it.lsf_priors(fg)
    assert len(pri) == 1 and fg.factor(pri[0]).is_prior
    assert all(not fg.factor(lbl).is_prior
               for lbl in fg.lsf() if lbl not in pri)
    f, g = fg.factor(fg.lsf()[0]), fg.factor(fg.lsf()[1])
    assert it.compare_all_special(f, f)
    assert not it.compare_all_special(f, g, show=False)
    assert it.compare_factors(f, f) and not it.compare_factors(f, g)


# -- tests/test_tree_functions.py ---------------------------------------------

def _factor_by_vars(fg, *vars_):
    want = set(vars_)
    for fl in fg.lsf():
        if set(fg.factor(fl).variables) == want:
            return fl
    raise KeyError(want)


def test_clique_factors_458_example1():
    fg = it.initfg(device="cpu")
    for v in ("x0", "x1", "x2", "x3", "x4", "l0", "l1"):
        fg.add_variable(v, it.ContinuousScalar)
    for pair in (("x0", "x1"), ("x1", "x2"), ("x2", "x3"), ("x3", "x4"),
                 ("x0", "l0"), ("x2", "l0"), ("x0", "l1"), ("x2", "l1")):
        fg.add_factor(list(pair), it.LinearRelative(it.Normal(0.0, 1.0)),
                      graphinit=False)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)), graphinit=False)
    fg.add_factor(["l0"], it.Prior(it.Normal(0.0, 1.0)), graphinit=False)
    tree = it.build_tree(fg, order=["x2", "x0", "l0", "x3", "x1", "l1", "x4"])
    assert sorted(f for c in tree.cliques.values()
                  for f in c.frontals) == sorted(fg.ls())
    assert sorted(p for c in tree.cliques.values()
                  for p in c.potentials) == sorted(fg.lsf())
    c3 = tree.clique_of("x0")
    expect = {_factor_by_vars(fg, "x0", "l0"), _factor_by_vars(fg, "x0", "l1"),
              _factor_by_vars(fg, "x0", "x1"), _factor_by_vars(fg, "x0")}
    assert expect <= set(c3.potentials)
    sub = build_clique_subgraph(fg, c3)
    assert expect <= set(sub.lsf())
    assert set(sub.ls()) == set(c3.frontals) | set(c3.separator)


def test_clique_factors_458_example2_partition():
    fg = it.initfg(device="cpu")
    for v in ("x0", "x1", "x2", "x3", "lm0", "lm3"):
        fg.add_variable(v, it.ContinuousScalar)
    for pair in (("x0", "x1"), ("x1", "x2"), ("x2", "x3"), ("x0", "lm0"),
                 ("x1", "lm0"), ("x2", "lm3"), ("x3", "lm3")):
        fg.add_factor(list(pair), it.LinearRelative(it.Normal(0.0, 1.0)),
                      graphinit=False)
    tree = it.build_tree(fg, order=["x0", "x2", "x1", "lm3", "lm0", "x3"])
    flat = [p for c in tree.cliques.values() for p in c.potentials]
    assert sorted(flat) == sorted(fg.lsf())
    assert len(flat) == len(set(flat))


def test_clique_subgraph_line_step():
    fg = it.generate_line_step(4, landmark_priors_at=(0, 4), device="cpu")
    tree = it.build_tree(fg)
    for cl in tree.cliques.values():
        sub = build_clique_subgraph(fg, cl)
        assert set(sub.ls()) == set(cl.frontals) | set(cl.separator)
        for p in cl.potentials:
            assert p in sub.lsf()
            assert set(fg.factor(p).variables) <= set(cl.all_vars)


def test_delete_clique_reroots_children():
    fg = it.generate_line_step(3, pose_every=1, landmark_every=3,
                               pose_priors_at=(), landmark_priors_at=(0,),
                               sight_distance=2,
                               params=it.SolverParams(N=75, graphinit=True),
                               device="cpu")
    old_tree = it.solve_tree(fg)
    assert len(old_tree.root_ids) == 1
    root = old_tree.root_ids[0]
    assert old_tree.is_root(root)
    kids = [c.cid for c in old_tree.children(root)]
    old_tree.delete_clique(root)
    for k in kids:
        assert old_tree.is_root(k)
    assert set(old_tree.root_ids) == set(kids)
    tree = it.solve_tree(fg, old_tree=old_tree)
    assert tree.num_cliques() >= 1
    for lbl in fg.ls():
        truth = float(lbl.lstrip("xlm"))
        m = float(fg.points(lbl)[:, 0].mean())
        assert abs(m - truth) < 0.5, (lbl, m)


def test_analysis_nnz_kaess_hand_values():
    for dim in range(1, 101):
        assert tan.nnz_frontals(dim) == dim * (dim + 1) // 2
    tree = it.build_tree(it.generate_kaess(device="cpu"),
                         order=["l1", "l2", "x1", "x2", "x3"])
    by_front = {tuple(sorted(c.frontals)): c for c in tree.cliques.values()}
    assert tan.nnz_clique(by_front[("x2", "x3")]) == 3
    assert tan.nnz_clique(by_front[("l1", "x1")]) == 5
    assert tan.nnz_clique(by_front[("l2",)]) == 2
    assert tan.nnz_tree(tree) == 10


def test_kaess_tree_listing():
    tree = it.build_tree(it.generate_kaess(device="cpu"),
                         order=["l2", "l1", "x1", "x2", "x3"])
    assert tree.num_cliques() == 3
    root = tree.clique_of("x3")
    assert tree.is_root(root.cid) and set(root.frontals) == {"x3", "x2"}
    kids = tree.children(root.cid)
    assert len(kids) == 2
    kid_fronts = [set(k.frontals) for k in kids]
    assert {"x1", "l1"} in kid_fronts and {"l2"} in kid_fronts
    for k in kids:
        assert not tree.is_root(k.cid) and not k.children
        assert k.parent == root.cid
    assert repr(tree)


# -- tests/test_generic_api.py ------------------------------------------------

def test_distribution_dimensions():
    assert it.Uniform(0.0, 1.0).dim == 1
    assert it.Normal(0.0, 1.0).dim == 1
    assert it.MvNormal([1.0, 1.0, 0.1], [1.0, 1.0, 1.0]).dim == 3
    b = it.make_belief(it.Euclidean(1), torch.zeros((100, 1)))
    assert b.points.shape[1] == 1


def test_graph_exists():
    fg = it.initfg(device="cpu")
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_variable("x2", it.ContinuousScalar)
    f = fg.add_factor(["x1", "x2"], it.LinearRelative(it.Normal(0.0, 1.0)),
                      graphinit=False)
    fg.add_factor(["x2"], it.Prior(it.Normal(0.0, 1.0)), graphinit=False)
    assert fg.exists("x1") and not fg.exists("l13") and fg.exists(f.label)


def test_compare_variables_and_graphs():
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg2 = copy.deepcopy(fg)
    assert it.compare_graphs(fg, fg2)
    assert it.compare_variables(fg.var("x0"), fg2.var("x0"))
    assert it.compare_beliefs(fg.get_belief("x0"), fg2.get_belief("x0"))
    it.solve_tree(fg2)
    assert not it.compare_variables(fg.var("x0"), fg2.var("x0"))
    assert not it.compare_graphs(fg, fg2)


class _QuirkSampler(it.FactorModel):
    """tests/test_generic_api.py's factor whose sampler adds an offset."""

    def __init__(self, Z, offset):
        self.Z = Z
        self.offset = offset

    @property
    def zdim(self):
        return self.Z.dim

    def sample(self, gen, n):
        return self.Z.sample(gen, n) + self.offset.to(gen.device)

    def residual(self, z, x1, x2):
        return x2 - (x1 + z)

    def mean_cov(self):
        mu, cov = self.Z.mean_cov()
        return mu + self.offset.numpy(), cov


it.register_factor_model(_QuirkSampler, ("Z", "offset"))


def test_special_sampler_factor_solves():
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.3)))
    fg.add_factor(["x0", "x1"], _QuirkSampler(it.Normal(2.0, 0.3),
                                              torch.tensor([5.0])))
    it.solve_tree(fg)
    m = float(fg.points("x1")[:, 0].mean())
    assert abs(m - 7.0) < 0.8, m


def test_deepcopy_independent_memory():
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    before = fg.points("x0").clone()
    for fg2 in (copy.deepcopy(fg), it.deepcopy_graph(fg)):
        it.init_variable(fg2, "x0", np.full((100, 1), 99.0))
        assert torch.equal(fg.points("x0"), before)
        assert abs(float(fg2.points("x0").mean()) - 99.0) < 1e-6


# -- tests/test_graph_ops.py --------------------------------------------------

def test_remove_factor_and_variable():
    fg = it.initfg(device="cpu")
    fg.add_variable("a", it.ContinuousScalar)
    fg.add_variable("b", it.ContinuousScalar)
    fg.add_factor(["a"], it.Prior(it.Normal(0, 1)))
    f = fg.add_factor(["a", "b"], it.LinearRelative(it.Normal(10, 1)))
    fg.remove_factor(f.label)
    assert f.label not in fg.lsf() and fg.factors_of("b") == []
    with pytest.raises(KeyError):
        fg.remove_factor(f.label)
    fg.remove_variable("b")
    assert "b" not in fg.ls()
    it.solve_tree(fg)
    assert abs(float(fg.points("a").mean())) < 3.0
    with pytest.raises(ValueError):
        fg.remove_variable("a", remove_factors=False)
    fg.remove_variable("a")
    assert fg.ls() == [] and fg.lsf() == []


def test_remove_variable_keeps_the_graph_consistent():
    """Removing a variable drops its factors from every neighbour's list
    and from the demotion set of ``ensure_solvable``; a re-added label
    starts clean and the graph solves."""
    from incrementalinference_torch.graphinit import ensure_solvable
    fg = _chain(4, graphinit=False)
    fg.add_variable("lone", it.ContinuousScalar)
    assert ensure_solvable(fg) == ["lone"]
    fg.remove_variable("lone")
    assert "lone" not in fg._auto_demoted
    fg.remove_variable("x2")
    for v in fg.ls():
        for fl in fg.factors_of(v):
            assert fl in fg.factors and "x2" not in fg.factor(fl).variables
    fg.add_variable("x2", it.ContinuousScalar)
    assert fg.factors_of("x2") == []
    fg.add_factor(["x1", "x2"], it.LinearRelative(it.Normal(10.0, 0.5)),
                  graphinit=False)
    it.solve_tree(fg)
    assert abs(float(fg.points("x2").mean()) - 20.0) < 2.0


def test_wrong_association_correction():
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.5)))
    for i in (1, 2):
        fg.add_variable(f"x{i}", it.ContinuousScalar)
        fg.add_factor([f"x{i - 1}", f"x{i}"],
                      it.LinearRelative(it.Normal(10.0, 0.5)))
    bad = fg.add_factor(["x0", "x2"], it.LinearRelative(it.Normal(100.0,
                                                                  0.5)))
    it.solve_tree(fg)
    assert float(fg.points("x2")[:, 0].mean()) > 30.0
    fg.remove_factor(bad.label)
    it.reset_initial_values(fg)
    it.solve_tree(fg)
    m = float(fg.points("x2")[:, 0].mean())
    assert abs(m - 20.0) < 3.0, m


def test_tag_filtered_listing():
    fg = it.initfg(device="cpu")
    fg.add_variable("a", it.ContinuousScalar, tags=("POSE",))
    fg.add_variable("l", it.ContinuousScalar, tags=("LANDMARK",))
    fg.add_factor(["a"], it.Prior(it.Normal(0, 1)), tags=("PRIOR",))
    assert fg.ls(tags=("POSE",)) == ["a"]
    assert fg.ls(tags=("LANDMARK",)) == ["l"]
    assert fg.lsf(tags=("PRIOR",)) == fg.lsf()


def test_solve_under_alternate_solvekey():
    fg = it.initfg(device="cpu")
    fg.add_variable("a", it.ContinuousScalar)
    fg.add_factor(["a"], it.Prior(it.Normal(5.0, 1.0)))
    fg.add_variable("b", it.ContinuousScalar)
    fg.add_factor(["a", "b"], it.LinearRelative(it.Normal(10.0, 1.0)))
    it.solve_tree(fg)
    for v in fg.ls():
        b = fg.get_belief(v)
        fg.set_belief(v, b.points, solve_key="alt", bw=b.bw, ipc=b.ipc)
    it.solve_tree(fg, solve_key="alt")
    pd = fg.get_belief("b", "default").points
    pa = fg.get_belief("b", "alt").points
    assert abs(float(pa.mean()) - 15.0) < 3.0 and pd.shape == pa.shape


# -- orderings: tests/test_native.py:26-32 and the qr order -------------------

def test_ccolamd_order_valid_and_constrained():
    fg = it.generate_test_symbolic(device="cpu")
    order = it.get_elimination_order(fg, "ccolamd")
    assert sorted(order) == sorted(fg.ls())
    order2 = it.get_elimination_order(fg, "ccolamd", constraints=["x5", "x4"])
    assert set(order2[-2:]) == {"x4", "x5"}


def test_ccolamd_beats_qr_on_line_graph():
    fg = it.generate_line_step(40, graphinit=False, device="cpu")
    cost_md = tan.tree_cost_01(it.build_tree(
        fg, order=it.get_elimination_order(fg, "ccolamd")))
    cost_qr = tan.tree_cost_01(it.build_tree(
        fg, order=it.get_elimination_order(fg, "qr")))
    assert cost_md <= cost_qr


_ORDER_GRAPHS = {
    "test_symbolic": lambda: jl.canonical.generate_test_symbolic(),
    "line_step_40": lambda: jl.canonical.generate_line_step(
        40, graphinit=False),
    "kaess": lambda: jl.canonical.generate_kaess(),
    "caesar_ring1d": lambda: jl.canonical.generate_caesar_ring1d(),
}


@pytest.mark.parametrize("name", list(_ORDER_GRAPHS))
def test_qr_order_matches_jax_label_for_label(name):
    """The default order (qr, as in the JAX package) on the graphs of
    tests/test_native.py and the canonical ones: equal label for label,
    with and without constraints; the ccolamd order too."""
    gj = _ORDER_GRAPHS[name]()
    gt = _carried(gj)
    assert it.get_elimination_order(gt) == jl.get_elimination_order(gj)
    cons = gj.ls()[:2]
    assert (it.get_elimination_order(gt, "qr", constraints=cons)
            == jl.get_elimination_order(gj, "qr", constraints=cons))
    if jax_native_ordering_available():
        assert (it.get_elimination_order(gt, "ccolamd")
                == jl.get_elimination_order(gj, "ccolamd"))
    with pytest.raises(ValueError):
        it.get_elimination_order(gt, "nosuch")


# -- single functions ---------------------------------------------------------

def test_ppe_batched_matches_ppe_and_jax():
    """ppe_batched of several beliefs equals ppe one by one (1e-6) and the
    JAX package's ppe_batched on the same beliefs (mean 1e-5, max 1e-4), on
    R¹ and on SE(2)."""
    from incrementalinference.jl_tpu import beliefs as jb
    from incrementalinference_torch import beliefs as tb
    r = rng(2)
    for mt, mj, pts in (
            (it.Euclidean(1), jl.Euclidean(1),
             r.normal(size=(4, 60, 1)).astype(np.float32)),
            (it.SE2(), jl.SE2(),
             np.concatenate([r.normal(size=(3, 60, 2)),
                             r.uniform(-1, 1, size=(3, 60, 1))],
                            -1).astype(np.float32))):
        bts = [tb.make_belief(mt, t(p)) for p in pts]
        bjs = [jb.make_belief(mj, np.asarray(p), bw=b.bw.numpy())
               for p, b in zip(pts, bts)]
        batched = tb.ppe_batched(mt, bts)
        for got, b in zip(batched, bts):
            one = tb.ppe(mt, b)
            for k in ("mean", "max", "suggested"):
                np.testing.assert_allclose(got[k].numpy(), one[k].numpy(),
                                           atol=1e-6)
        for got, want in zip(batched, jb.ppe_batched(mj, bjs)):
            np.testing.assert_allclose(got["mean"].numpy(),
                                       np.asarray(want["mean"]), atol=1e-5)
            np.testing.assert_allclose(got["max"].numpy(),
                                       np.asarray(want["max"]), atol=1e-4)


def test_calc_helix_t_against_jax():
    for kw in ({}, {"t_stop": 2.0, "points_per_turn": 8, "direction": 1,
                    "radius": 2.0}):
        for a, b in zip(it.canonical.calc_helix_T(**kw),
                        jl.canonical.calc_helix_T(**kw)):
            np.testing.assert_array_equal(a, b)


def test_incr_suffix_against_jax():
    for args in (("x45_4",), ("x45", 3), ("x45_4", -1), ("l1", 10)):
        assert it.incr_suffix(*args) == jl.incr_suffix(*args)
    with pytest.raises(ValueError):
        it.incr_suffix("abc")


def test_delete_msg_factors_like_jax():
    """Message factors added to a clique subgraph and deleted again, all at
    once or by label: the subgraph's factors and adjacency as in JAX."""
    gj = jl.canonical.generate_line_step(6, graphinit=True)
    gt = _carried(gj)
    tj, tt = jl.build_tree(gj, order=gj.ls()), it.build_tree(gt,
                                                             order=gj.ls())
    cid = [c for c in tj.cliques.values() if c.separator][0].cid
    sj = jl_subgraph(gj, tj.clique(cid))
    st = build_clique_subgraph(gt, tt.clique(cid))
    sep = tj.clique(cid).separator
    mj = jmsg.LikelihoodMessage(sender=99, status=jl.CliqStatus.UPSOLVED,
                                beliefs={v: gj.get_belief(v) for v in sep})
    mt = tmsg.LikelihoodMessage(sender=99, status=it.CliqStatus.UPSOLVED,
                                beliefs={v: gt.get_belief(v) for v in sep})
    aj, at = jmsg.add_msg_factors(sj, mj), tmsg.add_msg_factors(st, mt)
    assert at == aj and st.lsf() == sj.lsf()
    jmsg.delete_msg_factors(sj, aj[:1])
    tmsg.delete_msg_factors(st, at[:1])
    assert st.lsf() == sj.lsf()
    jmsg.delete_msg_factors(sj)
    tmsg.delete_msg_factors(st)
    assert st.lsf() == sj.lsf()
    for v in st.ls():
        assert st.factors_of(v) == sj.factors_of(v)
