"""The port's analytic tutorials (tntorch_tpu_torch/examples/, the first
eight of ``examples.NAMES``) on the CPU in float64, held to the JAX
tutorials' figures and to their own claims by
``tntorch_tpu_torch.examples.expected.check``; the pins of the subpackage.

Each tutorial runs in-process (``main(device="cpu", dtype=torch.float64)``):
unlike the JAX scripts it configures nothing global but torch's default
dtype, which it restores. The training tutorials are in
``tests/test_torch_examples_fit.py``.

Run as a script (``PYTHONPATH=. python tests/test_torch_examples.py``), this file runs
each JAX tutorial (``examples/<name>.py``) through the JAX package on the
CPU in float64 and prints ``expected.JAX``, the table the tests hold the
port to.
"""

import importlib
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from tntorch_tpu_torch.examples import NAMES, expected, resolve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYTIC = NAMES[:8]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ANALYTIC)
def test_tutorial_matches_jax(name):
    module = importlib.import_module(f"tntorch_tpu_torch.examples.{name}")
    prev = torch.get_default_dtype()
    out = module.main(device="cpu", dtype=torch.float64)
    assert torch.get_default_dtype() == prev
    failed = expected.check(name, out, torch.float64)
    assert not failed, failed


def test_every_jax_tutorial_has_a_port():
    # multichip.py too, since the port has parallel/
    jax_names = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py")}
    ported = {f[:-3] for f in os.listdir(os.path.join(ROOT, "tntorch_tpu_torch", "examples"))
              if f.endswith(".py") and f not in ("__init__.py", "expected.py")}
    assert ported == jax_names == set(NAMES)
    assert set(expected.RULES) == set(expected.JAX) == set(NAMES)
    assert set(expected.CPU_CAPS) == set(NAMES[8:])


def test_entry_point_runs_on_the_cpu():
    env = dict(os.environ, TN_DEVICE="cpu")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "tntorch_tpu_torch.examples.logic_and_automata"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "strings of weight 3: 120 (C(10,3) = 120)" in proc.stdout


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.delenv("TN_DEVICE", raising=False)
    assert resolve(device="cpu") == (torch.device("cpu"), torch.float64)
    assert resolve(device="cpu", dtype=torch.float32)[1] == torch.float32
    monkeypatch.setenv("TN_DEVICE", "cpu")
    assert resolve() == (torch.device("cpu"), torch.float64)
    monkeypatch.setenv("TN_DEVICE", "tpu")
    if torch.cuda.is_available():
        assert resolve() == (torch.device("cuda"), torch.float32)
    else:  # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="TN_DEVICE=cpu"):
            resolve()
        module = importlib.import_module("tntorch_tpu_torch.examples.logic_and_automata")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.main()


# ----------------------------------------------------------------------
# The recorder of ``expected.JAX`` (run as a script; imports JAX)
# ----------------------------------------------------------------------

def record(name):
    """Run ``examples/<name>.py``'s ``main()`` through the JAX package and
    capture its printed lines, the value of every ``float()`` it takes,
    the result of every ``tn.*`` call (in order, by name) and ``main``'s
    locals at its return."""
    import builtins
    import contextlib
    import io

    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # TN_DEVICE=cpu: the CPU in float64
    jtn = module.tn
    floats, calls, final = [], {}, {}

    def recording_float(x=0.0):
        floats.append(builtins.float(x))
        return floats[-1]

    class Recording:
        def __getattr__(self, attr):
            obj = getattr(jtn, attr)
            if not callable(obj):
                return obj

            def call(*args, **kwargs):
                result = obj(*args, **kwargs)
                calls.setdefault(attr, []).append(result)
                return result
            return call

    def on_return(code, offset, value):  # called from main's returning frame
        final.update(sys._getframe(1).f_locals)

    module.float, module.tn = recording_float, Recording()
    lines = io.StringIO()
    monitoring, tool = sys.monitoring, sys.monitoring.PROFILER_ID
    monitoring.use_tool_id(tool, "tutorial figures")
    monitoring.register_callback(tool, monitoring.events.PY_RETURN, on_return)
    monitoring.set_local_events(tool, module.main.__code__, monitoring.events.PY_RETURN)
    try:
        with contextlib.redirect_stdout(lines):
            module.main()
    finally:
        monitoring.set_local_events(tool, module.main.__code__, 0)
        monitoring.register_callback(tool, monitoring.events.PY_RETURN, None)
        monitoring.free_tool_id(tool)
    return lines.getvalue().splitlines(), floats, calls, final


def _figures(name, floats, calls, v):
    """The JAX tutorial's figures under the keys of the port's ``main()``."""
    import numpy as np

    def ints(x):
        return [int(r) for r in np.asarray(x).reshape(-1)]

    def floats_of(x):
        return [float(r) for r in np.asarray(x).reshape(-1)]

    f = floats
    if name == "decompositions":
        T = calls["Tensor"]  # full, ranks_tt=3, ranks_tucker=3, ranks_cp=3, hybrid, eps, randomized
        out = {}
        for k, (t, e) in enumerate(zip(T[1:4], f[:3])):
            key = ("tt", "tucker", "cp")[k]
            out.update({f"{key}_numcoef": int(t.numcoef()), f"{key}_rel_err": e,
                        f"{key}_ranks_tt": ints(t.ranks_tt),
                        f"{key}_ranks_tucker": ints(t.ranks_tucker)})
        return {**out, "tt_tucker_rel_err": f[3], "eps_ranks": ints(T[5].ranks_tt),
                "eps_rel_err": f[4], "randomized_rel_err": f[5],
                "round_ranks": ints(v["u"].ranks_tt)}
    if name == "arithmetics_and_formats":
        R = calls["round"]
        descs = ["TT", "TT-Tucker", "TT-Tucker (partial)", "Tucker (as TT-Tucker)", "CP",
                 "hybrid TT-CP", "CP-Tucker"]
        return {"max_rank": int(max(R[0].ranks_tt)), "value": f[0],
                "assigned": np.asarray(calls["ones"][2].full()).tolist(),
                "ranks": ints(R[1].ranks_tt), "mean": f[1], "var": f[2],
                "zoo": {d: int(t.numcoef()) for d, t in zip(descs, calls["rand"])}}
    if name == "sobol_indices":
        return {"first_order": f[:4], "closed_x0_x1": f[4], "total_x0": f[5],
                "mean_dimension": f[6], "dimension_distribution": floats_of(v["dd"][:5]),
                "mean": f[7], "var": f[8]}
    if name == "logic_and_automata":
        return {"satisfying": int(round(f[0])), "satisfiable": bool(calls["is_satisfiable"][0]),
                "tautology": bool(calls["is_tautology"][0]), "implies": bool(calls["implies"][0]),
                "relevant": [int(i) for i in calls["relevant_symbols"][0]],
                "weight_3": int(round(f[1])), "accepted": np.asarray(v["Xs"][:5]).tolist(),
                "weight_at": f[2]}
    if name == "vector_fields":
        return {"gradient_ranks": [int(max(g.ranks_tt)) for g in v["g"]], "curl_norms": f[:3],
                "div_minus_laplacian": f[3], "eigenvalues": floats_of(v["w"]),
                "round_ranks": ints(v["batch"].ranks_tt), "batch": int(v["batch"].b()),
                "sum_shape": [int(s) for s in v["s"].shape]}
    if name == "anova_active_subspaces":
        ev = np.asarray(v["ev"])
        return {"kept_without_w": f[0] * 100, "var_f0": f[1], "f0": f[2], "mean": f[3],
                "reassembly_rel_err": f[4], "order2_rel_err": f[5],
                "sobol_without_w": f[6] * 100, "sobol_singletons": f[7] * 100,
                "eigenvalues": floats_of(ev), "smallest_share": float(100 * ev.min() / ev.sum())}
    if name == "cross_approximation":
        return {"hilbert_ranks": ints(v["t"].ranks_tt), "matrix_rel_err": f[0],
                "square_rel_err": f[1], "inverse_rel_err": f[2], "min_found": f[3],
                "min_true": f[4], "argmax": [int(i) for i in calls["argmax"][0]],
                "grad_max": f[5], "host_val_eps": float(v["hinfo"]["val_eps"]),
                "host_ranks": ints(v["hb"].ranks_tt)}
    if name == "batch_ensembles":
        return {"means": floats_of(calls["mean"][0]), "stds": floats_of(calls["std"][0]),
                "sobol_0": floats_of(v["s0"]), "dimension_distribution_0": floats_of(v["dd"][0]),
                "stacked_shape": [int(s) for s in v["small"].shape],
                "stacked_ranks": ints(v["small"].ranks_tt), "stacked_errors": f[:3],
                "preserved": all(e < 1e-7 for e in f[:3]),
                "centered_max": float(np.abs(np.asarray(calls["mean"][-1])).max()),
                "centered": bool(np.abs(np.asarray(calls["mean"][-1])).max() < 1e-10),
                "rounded_ranks": ints(v["s"].ranks_tt)}
    if name == "completion":
        L = calls["optimize"]
        return {"iters": len(L[0]), "final_loss": float(L[0][-1]), "rel_err": f[0],
                "smooth_iters": len(L[1]), "smooth_final_loss": float(L[1][-1]),
                "als_rel_err": f[1], "sparse_ranks": ints(calls["sparse_tt_svd"][0].ranks_tt),
                "sparse_rel_err": f[2]}
    if name == "pce":
        L = calls["optimize"]
        return {"plain_iters": len(L[0]), "plain_test_rel_err": f[0],
                "plain_dof": int(calls["dof"][0]), "pce_iters": len(L[1]),
                "pce_test_rel_err": f[1], "pce_dof": int(calls["dof"][1]),
                "lars_test_rel_err": float(v["rel"]), "lars_terms": len(v["pce"].coef)}
    if name == "classification":
        L, n = calls["optimize"][0], v["ntrain"]
        return {"iters": len(L), "train_xent": float(L[-1]), "test_accuracy": f[0],
                "classifier_accuracy": float(v["clf"].score(v["Xc"][n:], v["yc"][n:])),
                "ensemble_accuracy": float(v["ens"].score(v["Xc"][n:], v["yc"][n:]))}
    if name == "exponential_machines":
        L = calls["optimize"][0]
        return {"final_mse": float(L[-1]), "iters": len(L), "train_r2": 1 - f[0] / f[1]}
    if name == "multichip":
        def spec(x):  # the mesh axis of each dimension, or None
            s = list(x.sharding.spec)
            return s + [None] * (x.ndim - len(s))

        return {"devices": v["n"], "mesh_shape": list(v["shape"]), "dot": f[0], "norm": f[1],
                "batch_spec": spec(v["tbs"].cores[0]), "forward_shape": list(v["yv"].shape),
                "forward_spec": spec(v["yv"]), "round_ranks": ints(v["t_r"].ranks_tt),
                "round_rel_err": f[2],
                "batch_round_local_shapes": [list(c.sharding.shard_shape(c.shape))
                                             for c in v["brounded"][:2]],
                "iters": len(v["hist"]), "loss_first": float(v["hist"][0]),
                "loss_last": float(v["hist"][-1])}
    raise KeyError(name)


if __name__ == "__main__":
    import pprint

    os.environ["TN_DEVICE"] = "cpu"
    sys.path.insert(0, ROOT)
    table = {}
    for name in sys.argv[1:] or NAMES:
        lines, floats, calls, final = record(name)
        print("\n".join(f"# {line}" for line in lines), file=sys.stderr)
        table[name] = _figures(name, floats, calls, final)
    print("JAX = " + pprint.pformat(table, sort_dicts=False, width=100))
