"""The JAX tutorials' figures, and how the port's tutorials are held to them.

``JAX`` holds the figures of the JAX package's tutorials as they ran on the
CPU in float64 (``TN_DEVICE=cpu PYTHONPATH=. python examples/<name>.py``),
unrounded: ``PYTHONPATH=. python tests/test_torch_examples.py`` runs each script's
``main()`` through the JAX package, captures its figures (its prints, the
value of each ``float()`` it takes, the result of each ``tn.*`` call and
the locals of ``main`` at its return) and prints this table. The JAX
package is the round's frozen reference, so the table does not drift.

`check` holds one run of a port tutorial (its ``main()``'s dict):
- figures that depend on no random draw, in float64, against ``JAX`` by
  the rule ``RULES`` gives each: integers, ranks, booleans, index rows and
  shapes exactly; reals to 1e-10 relative (JAX's assigned matrix holds
  5.999999999999999, its TT arithmetic's roundoff); relative errors from
  `tn.relative_error` in their square (its dot expansion cancels: a figure
  e carries ~1e-15 / e of absolute roundoff, 5e-5 relative at e = 3e-6);
  the ranks of an unseeded cross, rounded, as JAX's or one kickrank more;
  figures through cross pivots or randomized sketches (CP-ALS, the
  randomized TT-SVD) below 10x the JAX figure (or the crosses' eps,
  1e-6, where that is larger), since pivots and sketches
  differ (ROADMAP queue 3, "Cross index sets", "The randomized sketches");
- the claims the tutorial prints (curl grad = 0, C(10,3) = 120, ...) and
  the figures that depend on a ``jax.random`` draw, which the port cannot
  replay, by thresholds (`_claims`), each derived from the JAX figure with
  its margin stated. Training figures have a bound for the uncapped run
  (the card) and one for the CPU's short run under ``CPU_CAPS``.
In float32 (the training tutorials on the card) only the exact rules and
the claims apply.
"""

import math

# Iteration caps of the training tutorials on the CPU, where a step of the
# plain evaluation costs 5-14 ms: each keeps its file of tests under a
# minute of one core and still lets the tutorial's claim show (pce needs
# 1000 steps before the fixed-basis fit beats the free one)
CPU_CAPS = {"completion": dict(max_iter=300), "pce": dict(max_iter=1000),
            "classification": dict(max_iter=300), "exponential_machines": dict(max_iter=300),
            "multichip": {}}  # 50 steps on 8 ranks: ~20 s of the CPU, uncapped

EXACT, ANALYTIC, ERROR, PIVOTS, KICKED = "exact", "analytic", "error", "pivots", "kicked"
# The ranks of a rounded unseeded cross: its validation set is drawn anew
# each run, so it may stop one rank increase (kickrank, 3) later: in 100
# runs of 1/(1 + x + y + z + w), the JAX package rounded to ranks 7 in 97
# and 10 in 3, the port likewise (seed by seed, pivots differ: ROADMAP
# queue 3, "Cross index sets")
KICKRANK = 3
ANALYTIC_RTOL = 1e-10
# relative_error's dot expansion: |e^2 - e_jax^2| within 1e-10 of e_jax^2
# plus 1e-14 (sums of ~10^6 float64 products of unit size, each side)
ERROR_RTOL, ERROR_ATOL = 1e-10, 1e-14
# through cross pivots or a sketch: within 10x the JAX figure, or within the
# crosses' eps, 1e-6, where that is larger (JAX reads 0 for 1/t: the dot
# expansion's clamp; the port's unseeded 1/t read up to 3.2e-8 in 20 runs)
PIVOT_FACTOR, PIVOT_FLOOR = 10.0, 1e-6

RULES = {
    "decompositions": {
        **{f"{k}_{f}": EXACT for k in ("tt", "tucker", "cp")
           for f in ("numcoef", "ranks_tt", "ranks_tucker")},
        "tt_rel_err": ERROR, "tucker_rel_err": ERROR, "cp_rel_err": PIVOTS,
        "tt_tucker_rel_err": ERROR, "eps_ranks": EXACT, "eps_rel_err": ERROR,
        "randomized_rel_err": PIVOTS, "round_ranks": EXACT},
    "arithmetics_and_formats": {"max_rank": EXACT, "value": ANALYTIC, "assigned": ANALYTIC,
                                "ranks": KICKED, "zoo": EXACT},
    "sobol_indices": {"first_order": ANALYTIC, "closed_x0_x1": ANALYTIC, "total_x0": ANALYTIC,
                      "mean_dimension": ANALYTIC, "dimension_distribution": ANALYTIC,
                      "mean": ANALYTIC, "var": ANALYTIC},
    "logic_and_automata": {**{k: EXACT for k in ("satisfying", "satisfiable", "tautology",
                                                 "implies", "relevant", "weight_3", "accepted")},
                           "weight_at": ANALYTIC},
    "vector_fields": {"gradient_ranks": EXACT, "eigenvalues": ANALYTIC, "round_ranks": EXACT,
                      "batch": EXACT, "sum_shape": EXACT},
    "anova_active_subspaces": {},
    "cross_approximation": {"hilbert_ranks": EXACT, "matrix_rel_err": PIVOTS,
                            "square_rel_err": PIVOTS, "inverse_rel_err": PIVOTS},
    "batch_ensembles": {"stacked_shape": EXACT, "stacked_ranks": EXACT, "preserved": EXACT,
                        "centered": EXACT, "rounded_ranks": EXACT},
    "completion": {"sparse_ranks": EXACT},
    "pce": {"plain_dof": EXACT, "pce_dof": EXACT, "lars_test_rel_err": ANALYTIC,
            "lars_terms": EXACT},
    "classification": {},
    "exponential_machines": {},
    # per rank: each dp shard holds 8 TTs, on the CPU's 8 ranks as on the card's 4
    "multichip": {"round_ranks": EXACT, "forward_shape": EXACT, "forward_spec": EXACT,
                  "batch_spec": EXACT, "batch_round_local_shapes": EXACT, "iters": EXACT},
}

# The JAX tutorials' figures (CPU, float64), printed by
# ``PYTHONPATH=. python tests/test_torch_examples.py``
JAX = {'decompositions': {'tt_numcoef': 1920,
                    'tt_rel_err': 0.03226361880447333,
                    'tt_ranks_tt': [1, 3, 3, 1],
                    'tt_ranks_tucker': [128, 128, 128],
                    'tucker_numcoef': 51072,
                    'tucker_rel_err': 0.03324028185980294,
                    'tucker_ranks_tt': [1, 128, 128, 1],
                    'tucker_ranks_tucker': [3, 3, 3],
                    'cp_numcoef': 1152,
                    'cp_rel_err': 0.03367881087174087,
                    'cp_ranks_tt': [3, 3, 3, 3],
                    'cp_ranks_tucker': [128, 128, 128],
                    'tt_tucker_rel_err': 0.020897390840979746,
                    'eps_ranks': [1, 9, 128, 1],
                    'eps_rel_err': 3.003045258443735e-06,
                    'randomized_rel_err': 0.032284290544454766,
                    'round_ranks': [1, 3, 3, 1]},
 'arithmetics_and_formats': {'max_rank': 1,
                             'value': -2.0000000000000178,
                             'assigned': [[5.999999999999999, 5.999999999999999, 2.0, 2.0, 2.0],
                                          [5.999999999999999, 5.999999999999999, 2.0, 2.0, 2.0],
                                          [5.999999999999999, 5.999999999999999, 2.0, 2.0, 2.0],
                                          [2.9999999999999996, 2.9999999999999996, 1.0, 1.0, 1.0],
                                          [2.9999999999999996, 2.9999999999999996, 1.0, 1.0, 1.0]],
                             'ranks': [1, 7, 7, 7, 1],
                             'mean': 0.9999999966870907,
                             'var': 4.226301922750474e-14,
                             'zoo': {'TT': 2720,
                                     'TT-Tucker': 1470,
                                     'TT-Tucker (partial)': 2361,
                                     'Tucker (as TT-Tucker)': 903,
                                     'CP': 640,
                                     'hybrid TT-CP': 896,
                                     'CP-Tucker': 680}},
 'sobol_indices': {'first_order': [0.2895202291761275,
                                   0.13420946793859417,
                                   0.07712505584712658,
                                   0.05000315646421897],
                   'closed_x0_x1': 0.46776717878207263,
                   'total_x0': 0.46505052549731823,
                   'mean_dimension': 1.3262415883566976,
                   'dimension_distribution': [0.7232537135271951,
                                              0.23215500759251895,
                                              0.04002063300645863,
                                              0.004253425421906167,
                                              0.0003016384125913899],
                   'mean': 1.4155918306830504,
                   'var': 2.2711012809007034},
 'logic_and_automata': {'satisfying': 640,
                        'satisfiable': True,
                        'tautology': True,
                        'implies': True,
                        'relevant': [0, 1, 2, 3, 4],
                        'weight_3': 120,
                        'accepted': [[0, 0, 0, 1, 1],
                                     [0, 0, 1, 0, 1],
                                     [0, 0, 1, 1, 0],
                                     [0, 1, 0, 0, 1],
                                     [0, 1, 0, 1, 0]],
                        'weight_at': 3.0},
 'vector_fields': {'gradient_ranks': [2, 2, 2],
                   'curl_norms': [0.0, 0.0, 0.0],
                   'div_minus_laplacian': 0.0,
                   'eigenvalues': [1.8222514292320846, 0.1676443368290012, 0.08868597253980792],
                   'round_ranks': [1, 3, 3, 1],
                   'batch': 8,
                   'sum_shape': [8, 64, 64, 64]},
 'anova_active_subspaces': {'kept_without_w': 65.0269262199892,
                            'var_f0': -3.4844059937504515e-14,
                            'f0': 7.972275221745017,
                            'mean': 7.972275221745016,
                            'reassembly_rel_err': 0.0,
                            'order2_rel_err': 0.029871492483293918,
                            'sobol_without_w': 65.02692621998908,
                            'sobol_singletons': 65.0269262199893,
                            'eigenvalues': [2321.113090713158,
                                            324.9319644369764,
                                            0.11965819173477307,
                                            0.0046994559086415135],
                            'smallest_share': 0.00017759467273385223},
 'cross_approximation': {'hilbert_ranks': [1, 10, 10, 10, 10, 1],
                         'matrix_rel_err': 0.0,
                         'square_rel_err': 6.483540615308934e-08,
                         'inverse_rel_err': 0.0,
                         'min_found': -61.30838593713781,
                         'min_true': -61.3083859371378,
                         'argmax': [2, 6, 2, 3],
                         'grad_max': 20335119.35591098,
                         'host_val_eps': 6.514951218601592e-07,
                         'host_ranks': [1, 10, 10, 1]},
 'batch_ensembles': {'means': [4.7668708959591095,
                               4.361794309239341,
                               4.863447854271897,
                               4.00305021706526,
                               3.9870405020390387,
                               5.458134323562919,
                               5.243926683341984,
                               6.058131909632258],
                     'stds': [2.369616639196188,
                              2.168590789276943,
                              2.417559802349823,
                              1.990078506980981,
                              1.9819213354545495,
                              2.7137624176356536,
                              2.6068170391119128,
                              3.0117544537663923],
                     'sobol_0': [0.3799678760525333,
                                 0.3798677217874351,
                                 0.37989863800197815,
                                 0.37998396069504936,
                                 0.379864742867452,
                                 0.37981464530602327,
                                 0.3799493298521072,
                                 0.3799149787098733],
                     'dimension_distribution_0': [0.8995703684705733,
                                                  0.09353051115405041,
                                                  0.006499281493218973,
                                                  0.0003998388821626483],
                     'stacked_shape': [3, 16, 16, 16, 16],
                     'stacked_ranks': [1, 5, 5, 5, 1],
                     'stacked_errors': [0.0, 1.6630204938079843e-08, 0.0],
                     'preserved': True,
                     'centered_max': 1.7763568394002505e-15,
                     'centered': True,
                     'rounded_ranks': [1, 8, 8, 8, 1]},
 'completion': {'iters': 3001,
                'final_loss': 0.000608253729330999,
                'rel_err': 0.03640290403575704,
                'smooth_iters': 1501,
                'smooth_final_loss': 0.00459578339371634,
                'als_rel_err': 7.606992099228479e-05,
                'sparse_ranks': [1, 3, 3, 1],
                'sparse_rel_err': 3.4158191532005046e-15},
 'pce': {'plain_iters': 5297,
         'plain_test_rel_err': 0.41399708529055207,
         'plain_dof': 512,
         'pce_iters': 7272,
         'pce_test_rel_err': 0.05378621806200432,
         'pce_dof': 48,
         'lars_test_rel_err': 0.04778251672786405,
         'lars_terms': 8},
 'classification': {'iters': 3001,
                    'train_xent': 0.06212148565919924,
                    'test_accuracy': 0.96,
                    'classifier_accuracy': 0.94,
                    'ensemble_accuracy': 0.98},
 'exponential_machines': {'final_mse': 0.009743196050855706,
                          'iters': 2095,
                          'train_r2': 0.995515614723299},
 'multichip': {'devices': 8,
               'mesh_shape': [4, 2],
               'dot': 310149.4078542212,
               'norm': 6415.32826003691,
               'batch_spec': ['dp', None, None, None],
               'forward_shape': [128],
               'forward_spec': ['dp'],
               'round_ranks': [1, 8, 8, 8, 1],
               'round_rel_err': 1.902791370169072e-08,
               'batch_round_local_shapes': [[8, 1, 8, 4], [8, 4, 8, 4]],
               'iters': 51,
               'loss_first': 784.2367145390895,
               'loss_last': 638.7768062885573}}


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for y in x for v in _flat(y)]
    return [x]


def _compare(rule, got, want):
    """None if ``got`` meets ``want`` under ``rule``, else the reason."""
    if rule == EXACT:
        return None if got == want else f"{got!r} != {want!r}"
    if rule == KICKED:
        ok = len(got) == len(want) and all(a in (b, b + KICKRANK) for a, b in zip(got, want))
        return None if ok else f"{got!r} against {want!r} (+{KICKRANK} allowed)"
    g, w = _flat(got), _flat(want)
    if len(g) != len(w):
        return f"{len(g)} values against {len(w)}"
    for a, b in zip(g, w):
        if rule == ANALYTIC:
            ok = abs(a - b) <= ANALYTIC_RTOL * abs(b)
        elif rule == ERROR:
            ok = abs(a * a - b * b) <= ERROR_RTOL * b * b + ERROR_ATOL
        else:
            ok = a <= max(PIVOT_FACTOR * b, PIVOT_FLOOR)
        if not (ok and math.isfinite(a)):
            return f"{got!r} against {want!r} ({rule})"
    return None


def _claims(name, out, capped, f64):
    """(description, holds) of each claim the tutorial prints and each
    threshold on a figure that depends on a draw."""
    o = out
    if name == "decompositions":
        return [("each format compresses", all(o[f"{k}_numcoef"] < 128**3
                                               for k in ("tt", "tucker", "cp"))),
                ("eps=1e-5 is met", o["eps_rel_err"] <= 1e-5)]
    if name == "arithmetics_and_formats":
        return [("(1+1)*(1-2) = -2 at rank 1", o["max_rank"] == 1 and abs(o["value"] + 2) < 1e-10),
                # sin and cos by cross at its eps, 1e-6 (JAX's runs: 3.3e-9 off
                # and exact to the 6 printed digits)
                ("sin^2 + cos^2 = 1", abs(o["mean"] - 1) < 1e-6),
                # JAX's runs 3.3e-15 and 4.2e-14 (its cross pivots are unseeded)
                ("var(sin^2 + cos^2) ~ 0", abs(o["var"]) < 1e-10)]
    if name == "sobol_indices":
        return [("first-order indices sum below 1", 0 < sum(o["first_order"]) <= 1),
                ("S_x0 <= S_{x0 or x1}", o["first_order"][0] <= o["closed_x0_x1"]),
                ("dimension distribution sums to at most 1",
                 sum(o["dimension_distribution"]) <= 1 + 1e-12)]
    if name == "logic_and_automata":
        return [("C(10,3) = 120 strings of weight 3", o["weight_3"] == 120),
                ("x | ~x is a tautology", o["tautology"] is True),
                ("x & y implies x", o["implies"] is True),
                ("accepted inputs have weight 2", all(sum(r) == 2 for r in o["accepted"])),
                ("weight at 1110000000 is 3", abs(o["weight_at"] - 3) < 1e-12)]
    if name == "vector_fields":
        # the fields' norms are ~1e3; the dot expansion of a norm carries
        # ~1e-16 of their squares, so an exact 0 reads up to ~1e-5
        return [("||curl grad phi|| ~ 0", all(abs(c) < 1e-4 for c in o["curl_norms"])),
                ("||div grad - laplacian|| ~ 0", abs(o["div_minus_laplacian"]) < 1e-4)]
    if name == "anova_active_subspaces":
        ev = o["eigenvalues"]
        return [  # JAX: -3.48e-14 against a mean of 7.97
            ("var(f_0) ~ 0", abs(o["var_f0"]) <= 1e-12 * o["mean"] ** 2),
            ("f_0 = mean", abs(o["f0"] - o["mean"]) <= 1e-10 * abs(o["mean"])),
            # JAX 0: an exact reassembly, read through the dot expansion
            ("full ANOVA reassembly", o["reassembly_rel_err"] <= 1e-6),
            ("variance kept without w = Sobol share without w",
             abs(o["kept_without_w"] - o["sobol_without_w"]) <= 1e-8 * o["sobol_without_w"]),
            ("kept share in (0, 100]", 0 < o["kept_without_w"] <= 100 + 1e-8),
            # JAX 0.0299: order <= 2 of 4 modes keeps most of a rank-5 rand
            ("order <= 2 truncation error in (0, 0.3)", 0 < o["order2_rel_err"] < 0.3),
            ("eigenvalues descending, nonnegative",
             all(a >= b for a, b in zip(ev, ev[1:])) and ev[-1] >= -1e-9 * ev[0]),
            # JAX 1.8e-4 %: x3 is inactive; a 56x margin
            ("the inactive input's share below 0.01%", o["smallest_share"] < 1e-2)]
    if name == "cross_approximation":
        return [("the minimum found is the true one",
                 abs(o["min_found"] - o["min_true"]) <= 1e-10 * abs(o["min_true"])),
                ("the argmax holds the maximum",
                 abs(o["value_at_argmax"] - o["max_true"]) <= 1e-10 * abs(o["max_true"])),
                # the replay of x**2 at its recorded pivots is exact up to
                # the least-squares solves
                ("grad through cross_forward = grad of normsq(w * w)",
                 abs(o["grad_max"] - o["grad_exact_max"]) <= 1e-6 * o["grad_exact_max"]),
                ("the host sweep converged", o["host_val_eps"] < 1e-6),
                # unseeded in the JAX tutorial: its runs reach ranks 10 or 13
                ("the host sweep's ranks at most 16", max(o["host_ranks"]) <= 16)]
    if name == "batch_ensembles":
        s0 = o["sobol_0"]
        return [("stacked members within 1e-7", all(e < 1e-7 for e in o["stacked_errors"])),
                ("centred means below 1e-10", o["centered_max"] < 1e-10),
                ("the .npz round trip is bitwise", o["round_trip"] is True),
                ("means and stds positive", min(o["means"]) > 0 and min(o["stds"]) > 0),
                # JAX 0.3798-0.3800: members are rescaled copies plus 5% noise
                ("S_0 alike across members", 0 < min(s0) and max(s0) - min(s0) < 0.01),
                ("member 0's dimension distribution sums to at most 1",
                 sum(o["dimension_distribution_0"]) <= 1 + 1e-6)]
    if name == "completion":
        eps = 2.2e-16 if f64 else 1.2e-7
        # JAX uncapped 0.036; the port on the CPU at 300 steps 0.28, uncapped 0.10
        bound = 0.5 if capped else 0.3
        return [(f"optimize() rel-err below {bound}", o["rel_err"] < bound),
                ("the smoothed fit's loss below 0.1", o["smooth_final_loss"] < 0.1),
                # JAX 5.9e-5 and 7.6e-5 in two runs (unseeded); a 13x margin
                ("ALS rel-err below 1e-3", o["als_rel_err"] < 1e-3),
                # JAX 3.4e-15; the sketch resolves directions to ~sqrt(eps)
                ("sparse_tt_svd exact at the samples", o["sparse_rel_err"] < 10 * math.sqrt(eps))]
    if name == "pce":
        if not f64:
            # In float32 both packages' descents stop after a few steps: the
            # loss starts at ~0.9992 and falls ~9e-6 a step, and Adam's first
            # steps decelerate in float32 roundoff, so tol=1e-4 declares
            # convergence (the JAX tutorial on the CPU in float32: 3 steps
            # each, test rel-errs 0.9995 and 0.9998). Held: no divergence,
            # and the LARS surrogate (JAX 0.0478 with 8 terms in float64)
            return [("the descents do not diverge",
                     max(o["plain_test_rel_err"], o["pce_test_rel_err"]) < 1.01),
                    ("PCE (LARS) test rel-err below 0.1", o["lars_test_rel_err"] < 0.1),
                    ("PCE (LARS) keeps 1-20 terms", 1 <= o["lars_terms"] <= 20)]
        # JAX 0.054 against 0.414 uncapped; the port at 1000 steps 0.24
        # against 0.45
        bound = 0.5 if capped else 0.15
        return [("the fixed basis generalizes better",
                 o["pce_test_rel_err"] < o["plain_test_rel_err"]),
                (f"PCE (GD) test rel-err below {bound}", o["pce_test_rel_err"] < bound)]
    if name == "classification":
        # JAX 0.96 / 0.94 / 0.98 and xent 0.062 uncapped; the port at 300
        # steps 0.98 / 0.98 / 0.96, xent 0.215
        acc, xent = (0.8, 0.3) if capped else (0.85, 0.1)
        return [(f"train xent below {xent}", o["train_xent"] < xent)] + [
            (f"{k} at least {acc}", o[k] >= acc)
            for k in ("test_accuracy", "classifier_accuracy", "ensemble_accuracy")]
    if name == "exponential_machines":
        # JAX R^2 0.9955 and mse 0.0097 (the noise's variance is 0.01); the
        # card in float32 0.9937-0.9955 and 0.0096-0.0134 in 4 runs (Adam at
        # lr 1e-2 spikes near the optimum, and the last step's loss is the
        # one printed); the port on the CPU at 300 steps 0.981 and 0.043
        r2, mse = (0.95, 0.1) if capped else (0.98, 0.05)
        return [(f"train R^2 above {r2}", o["train_r2"] > r2),
                (f"final mse below {mse}", o["final_mse"] < mse)]
    if name == "multichip":
        # float64 roundoff, or float32's (1.2e-7 a product); relative_error's
        # dot expansion floors an exact result at ~sqrt(eps): JAX read 1.9e-8
        # for the rounding (the port on the CPU 4.3e-8), float32 ~3e-4
        tol, floor = (1e-12, 1e-6) if f64 else (1e-5, 1e-2)
        return [("the mesh is (ranks / 2, 2)", o["mesh_shape"] == [o["devices"] // 2, 2]),
                ("sharded dot = one rank's dot",
                 abs(o["dot"] - o["dot_one_rank"]) <= tol * abs(o["dot_one_rank"])),
                ("sharded norm = one rank's norm",
                 abs(o["norm"] - o["norm_one_rank"]) <= tol * o["norm_one_rank"]),
                ("sharded forward = tt_eval", o["forward_err"] <= tol),
                ("sharded Gram rounding recovers 2a", o["round_rel_err"] <= floor),
                # JAX 784 -> 639 (0.81) over 50 Adam steps; the port's draws
                # on the CPU 532 -> 443 (0.83)
                ("dp training lowers the loss by a tenth",
                 o["loss_last"] < 0.9 * o["loss_first"])]
    raise KeyError(name)


def check(name, out, dtype, capped=False):
    """The failures of one run of tutorial ``name`` (its ``main()``'s dict
    ``out``) in ``dtype`` (a torch dtype), ``capped`` under ``CPU_CAPS``:
    an empty list if it meets the JAX figures and its claims."""
    f64 = str(dtype) == "torch.float64"
    failed = []
    for key, rule in RULES[name].items():
        if f64 or rule == EXACT:
            why = _compare(rule, out[key], JAX[name][key])
            if why:
                failed.append(f"{name}: {key} {why}")
    failed += [f"{name}: claim '{what}' fails" for what, holds in _claims(name, out, capped, f64)
               if not holds]
    return failed
