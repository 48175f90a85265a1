"""Boolean logic and weighted automata on 2^N tensors
(reference docs/tutorials/logic.ipynb, automata.ipynb). The port of
``examples/logic_and_automata.py``."""

import numpy as np

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running


def main(device=None, dtype=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        kw = dict(device=device, dtype=dtype)
        N = 10
        x = tn.symbols(N, **kw)

        # Compressed propositional calculus over 2^10 assignments
        f = (x[0] & x[1]) | (~x[2] & x[3]) ^ x[4]
        out["satisfying"] = int(round(float(tn.sum(f))))
        out["satisfiable"] = tn.is_satisfiable(f)
        out["tautology"] = tn.is_tautology(x[0] | ~x[0])
        out["implies"] = tn.implies(x[0] & x[1], x[0])
        out["relevant"] = figure(tn.relevant_symbols(f))
        print("satisfying assignments:", out["satisfying"])
        print("is satisfiable:", out["satisfiable"])
        print("tautology (x | ~x):", out["tautology"])
        print("(x&y -> x):", out["implies"])
        print("relevant symbols of f:", out["relevant"])

        # Hamming-weight automata
        wm = tn.weight_mask(N, 3, **kw)  # accepts strings with exactly three 1s
        out["weight_3"] = int(round(float(tn.sum(wm))))
        print("strings of weight 3:", out["weight_3"], "(C(10,3) = 120)")
        Xs = np.asarray(figure(tn.accepted_inputs(tn.weight_mask(5, 2, **kw))))
        out["accepted"] = Xs[:5].tolist()
        print("accepted inputs of weight-2/5 mask:\n", Xs[:5], "...")

        w = tn.weight(N, **kw)
        out["weight_at"] = float(w[tuple([1, 1, 1] + [0] * 7)])
        print("weight automaton at 1110000000:", out["weight_at"])
    return out


if __name__ == "__main__":
    main()
