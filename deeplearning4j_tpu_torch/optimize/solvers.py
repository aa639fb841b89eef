"""Full-batch optimizers: port of deeplearning4j_tpu/optimize/solvers.py
(LBFGS, ConjugateGradient, LineGradientDescent and BackTrackLineSearch;
the reference's optimize/solvers/ BaseOptimizer, LBFGS, ConjugateGradient,
LineGradientDescent and BackTrackLineSearch).

SGD is the production path (the containers' `fit`); these methods drive
the score and its gradient over the flat parameter vector from the host,
in float64 numpy, as the reference's loop does. The score is the
network's `make_flat_score_fn` callable (on the network's device) and the
gradient is `torch.autograd.grad` of it, where the reference jits
`jax.grad` of the same function.

Selected by `NeuralNetConfiguration.optimization_algo` ("lbfgs" |
"conjugate_gradient" | "line_gradient_descent"; "sgd" and
"stochastic_gradient_descent" call `net.fit`), through `Solver`.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger(__name__)


class BackTrackLineSearch:
    """Armijo backtracking line search.
    reference: optimize/solvers/BackTrackLineSearch.java."""

    def __init__(self, score_fn, grad_fn, max_iterations=20, c1=1e-4,
                 rho=0.5, min_step=1e-12):
        self.score_fn = score_fn
        self.grad_fn = grad_fn
        self.max_iterations = int(max_iterations)
        self.c1 = float(c1)
        self.rho = float(rho)
        self.min_step = float(min_step)

    def optimize(self, x, direction, initial_step=1.0):
        """Returns (step, new_x, new_score)."""
        f0 = float(self.score_fn(x))
        g0 = np.asarray(self.grad_fn(x))
        slope = float(g0 @ direction)
        if slope >= 0:
            direction = -g0          # not a descent direction: reset
            slope = float(g0 @ direction)
        step = float(initial_step)
        while step > self.min_step:
            x_new = x + step * direction
            f_new = float(self.score_fn(x_new))
            if np.isfinite(f_new) and f_new <= f0 + self.c1 * step * slope:
                return step, x_new, f_new
            step *= self.rho
        return 0.0, x, f0


class _BaseFlatOptimizer:
    """Drives the score and its gradient over the flat parameter vector
    (float64 numpy on the host; each evaluation runs on the network's
    device)."""

    def __init__(self, net, features, labels, fmask=None, lmask=None,
                 max_iterations=100, tolerance=1e-8):
        self.net = net
        flat_score = net.make_flat_score_fn(features, labels, fmask, lmask,
                                            train=True)

        def score_fn(x):
            with torch.no_grad():
                return float(flat_score(x))

        def grad_fn(x):
            v = torch.tensor(np.asarray(x, np.float64), requires_grad=True)
            (g,) = torch.autograd.grad(flat_score(v), v)
            return g.numpy()

        self.score_fn = score_fn
        self.grad_fn = grad_fn
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.line_search = BackTrackLineSearch(self.score_fn, self.grad_fn)

    def optimize(self):
        raise NotImplementedError

    def _finish(self, x, score):
        self.net.set_params(np.asarray(x))
        self.net._score = float(score)
        return float(score)


class LineGradientDescent(_BaseFlatOptimizer):
    """Steepest descent with a line search.
    reference: optimize/solvers/LineGradientDescent.java."""

    def optimize(self):
        x = self.net.params().astype(np.float64)
        score = float(self.score_fn(x))
        for _ in range(self.max_iterations):
            g = np.asarray(self.grad_fn(x), np.float64)
            step, x, new_score = self.line_search.optimize(x, -g)
            if step == 0.0 or abs(score - new_score) < self.tolerance:
                score = new_score
                break
            score = new_score
        return self._finish(x, score)


class ConjugateGradient(_BaseFlatOptimizer):
    """Nonlinear conjugate gradient (Polak-Ribiere with restarts).
    reference: optimize/solvers/ConjugateGradient.java."""

    def optimize(self):
        x = self.net.params().astype(np.float64)
        g = np.asarray(self.grad_fn(x), np.float64)
        d = -g
        score = float(self.score_fn(x))
        for it in range(self.max_iterations):
            step, x, new_score = self.line_search.optimize(x, d)
            if step == 0.0 or abs(score - new_score) < self.tolerance:
                score = new_score
                break
            score = new_score
            g_new = np.asarray(self.grad_fn(x), np.float64)
            beta = float(g_new @ (g_new - g) / max(g @ g, 1e-300))
            beta = max(0.0, beta)      # PR+ restart
            d = -g_new + beta * d
            g = g_new
            if (it + 1) % x.size == 0:
                d = -g                 # periodic restart
        return self._finish(x, score)


class LBFGS(_BaseFlatOptimizer):
    """Limited-memory BFGS (two-loop recursion, history m).
    reference: optimize/solvers/LBFGS.java."""

    def __init__(self, *args, m=10, **kw):
        super().__init__(*args, **kw)
        self.m = int(m)

    def optimize(self):
        x = self.net.params().astype(np.float64)
        g = np.asarray(self.grad_fn(x), np.float64)
        score = float(self.score_fn(x))
        s_hist, y_hist = [], []
        for _ in range(self.max_iterations):
            # two-loop recursion for H*g
            q = g.copy()
            alphas = []
            for s, y in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / max(y @ s, 1e-300)
                a = rho * (s @ q)
                alphas.append((a, rho, s, y))
                q -= a * y
            if y_hist:
                s, y = s_hist[-1], y_hist[-1]
                q *= (s @ y) / max(y @ y, 1e-300)
            for a, rho, s, y in reversed(alphas):
                b = rho * (y @ q)
                q += (a - b) * s
            d = -q
            step, x_new, new_score = self.line_search.optimize(x, d)
            if step == 0.0:
                # the LBFGS direction was rejected: drop the history and
                # retry steepest descent
                s_hist, y_hist = [], []
                step, x_new, new_score = self.line_search.optimize(x, -g)
            if step == 0.0 or abs(score - new_score) < self.tolerance:
                score = new_score
                x = x_new
                break
            g_new = np.asarray(self.grad_fn(x_new), np.float64)
            s, yv = x_new - x, g_new - g
            if s @ yv > 1e-10:          # keep only valid curvature pairs
                s_hist.append(s)
                y_hist.append(yv)
                if len(s_hist) > self.m:
                    s_hist.pop(0)
                    y_hist.pop(0)
            x, g, score = x_new, g_new, new_score
        return self._finish(x, score)


SOLVERS = {
    "lbfgs": LBFGS,
    "conjugate_gradient": ConjugateGradient,
    "line_gradient_descent": LineGradientDescent,
}


class Solver:
    """Facade dispatching on the configuration's optimization_algo.
    reference: optimize/Solver.java:41."""

    def __init__(self, net, algo=None, max_iterations=100):
        self.net = net
        self.algo = (algo or net.conf.global_conf.get(
            "optimization_algo", "stochastic_gradient_descent")).lower()
        self.max_iterations = max_iterations

    def optimize(self, features, labels, fmask=None, lmask=None):
        if self.algo in ("stochastic_gradient_descent", "sgd"):
            from ..datasets.dataset import DataSet
            return self.net.fit(DataSet(features, labels, fmask, lmask))
        cls = SOLVERS.get(self.algo)
        if cls is None:
            raise ValueError(f"Unknown optimization algorithm '{self.algo}'")
        opt = cls(self.net, features, labels, fmask, lmask,
                  max_iterations=self.max_iterations)
        return opt.optimize()
