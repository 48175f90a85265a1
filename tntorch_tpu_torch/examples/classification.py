"""Tensor classification on the two-class "Swiss roll" problem
(reference docs/tutorials/classification.ipynb; BASELINE config 3 family).

The classifier is a [nticks, nticks, C] TT-Tucker tensor with fixed DCT
factor bases: logits are tensor entries at the (discretized) feature
coordinates, trained with softmax cross-entropy through `tn.optimize`.
The port of ``examples/classification.py``. ``max_iter`` caps every fit's
iterations (3000 uncapped), for a short run on the CPU.
"""

import time

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import running, seconds_since
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None, max_iter=None) -> dict:
    out = {}
    iters = 3000 if max_iter is None else min(3000, max_iter)
    with running(device, dtype) as (device, dtype):
        rng = np.random.default_rng(0)
        N, C, P = 2, 2, 100  # features, classes, points per class

        # Two interleaved spirals (the tutorial's "Swiss roll")
        r = rng.uniform(2, 10, P)[:, None]
        c0 = np.concatenate([r * np.cos(r), r * np.sin(r)], axis=1)
        c0 += rng.standard_normal(c0.shape) / 1.5
        c1 = -c0

        X = np.concatenate([c0, c1], axis=0)
        y = np.concatenate([np.zeros(len(c0)), np.ones(len(c1))])
        idx = rng.permutation(len(X))
        X, y = X[idx], y[idx]

        # Discretize features onto a [0, nticks) grid
        nticks = 128
        X = (X - X.min()) / (X.max() - X.min()) * (nticks - 1)
        ntrain = int(len(X) * 0.75)
        X_train = torch.from_numpy(X[:ntrain].round().astype(np.int64)).to(device)
        y_train = torch.from_numpy(y[:ntrain].astype(np.int64)).to(device)
        X_test = torch.from_numpy(X[ntrain:].round().astype(np.int64)).to(device)
        y_test = np.asarray(y[ntrain:], dtype=np.int64)

        # Logit tensor: smooth (low-frequency DCT factors) over the 2 features
        t = tn.rand([nticks] * N + [C], ranks_tt=10, ranks_tucker=6, requires_grad=True,
                    generator=seed(0, "cpu"), device=device, dtype=dtype)
        t.set_factors("dct", dim=range(N))

        def loss(t):
            # Logits for every class at the sample coordinates: indexing with a
            # (P, 2) matrix on the [nticks, nticks, C] tensor leaves the class
            # mode free -> a (P, C) result
            logp = torch.log_softmax(t[X_train].full(), dim=-1)
            return -torch.mean(logp[torch.arange(len(y_train), device=device), y_train])

        t0 = time.perf_counter()
        losses = tn.optimize(t, loss, tol=1e-5, max_iter=iters, print_freq=500)
        out["iters"], out["train_xent"] = len(losses), losses[-1]
        out["seconds"] = seconds_since(t0, device)
        print("train xent {:.4f} after {} iters, {:.1f}s".format(
            out["train_xent"], out["iters"], out["seconds"]))

        with torch.no_grad():
            pred = torch.argmax(t[X_test].full(), dim=-1).cpu().numpy()
        out["test_accuracy"] = float((pred == y_test).mean())
        print("test accuracy:", out["test_accuracy"])

        # --- Same workflow, encapsulated: tn.TTClassifier (the reference
        # TODO.md's "Classifier()" item). Works on the raw continuous features;
        # discretization, the logit tensor, and the training loop are internal.
        Xc = np.concatenate([c0, c1], axis=0)[idx]  # raw features, same row order
        yc = y  # already permuted above
        clf = tn.TTClassifier(nticks=nticks, ranks_tt=10, ranks_tucker=6, max_iter=iters,
                              verbose=False, key=seed(0, "cpu"), device=device)
        clf.fit(Xc[:ntrain], yc[:ntrain])
        out["classifier_accuracy"] = float(clf.score(Xc[ntrain:], yc[ntrain:]))
        print("TTClassifier test accuracy:", out["classifier_accuracy"])

        # Bagged ensemble: 4 members trained together (a batch=True tensor),
        # probabilities averaged at predict time
        ens = tn.TTClassifier(nticks=nticks, ranks_tt=10, ranks_tucker=6, max_iter=iters,
                              n_estimators=4, verbose=False, key=seed(1, "cpu"), device=device)
        ens.fit(Xc[:ntrain], yc[:ntrain])
        out["ensemble_accuracy"] = float(ens.score(Xc[ntrain:], yc[ntrain:]))
        print("TTClassifier x4 ensemble test accuracy:", out["ensemble_accuracy"])
    return out


if __name__ == "__main__":
    main()
