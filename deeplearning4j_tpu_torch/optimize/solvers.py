"""Full-batch convex optimizers and line search (the JAX package's
``optimize/solvers.py``).

Ref: deeplearning4j-nn optimize/Solver.java:41-70 (dispatch on
OptimizationAlgorithm), optimize/solvers/{StochasticGradientDescent,
LineGradientDescent,ConjugateGradient,LBFGS,BackTrackLineSearch}.java.

The reference runs these against ``model.computeGradientAndScore()`` on
the current minibatch; here they run against a value-and-gradient
objective over a *flat* float64 host vector, so the same code optimizes
toy convex problems and whole networks. SGD itself lives in the
containers' train step; these are the line-search family, which
``fit_batch`` routes to when ``optimization_algo`` is not SGD. They read
``iterations`` (the outer loop) and ``max_num_line_search_iterations``
(the backtracking) of the training config.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

ValueGrad = Callable[[np.ndarray], Tuple[float, np.ndarray]]


def backtrack_line_search(f: Callable[[np.ndarray], float], x: np.ndarray,
                          fx: float, g: np.ndarray, direction: np.ndarray,
                          step0: float = 1.0, c1: float = 1e-4,
                          rho: float = 0.5, max_steps: int = 30,
                          ) -> float:
    """Armijo backtracking (ref: BackTrackLineSearch.java: the same
    sufficient-decrease test, geometric step shrink)."""
    m = float(g @ direction)
    if m >= 0:  # not a descent direction; signal caller to reset
        return 0.0
    step = step0
    for _ in range(max_steps):
        if f(x + step * direction) <= fx + c1 * step * m:
            return step
        step *= rho
    return 0.0


def minimize(value_grad: ValueGrad, x0: np.ndarray, method: str = "lbfgs",
             max_iters: int = 100, tol: float = 1e-8, history: int = 10,
             value_only: Optional[Callable[[np.ndarray], float]] = None,
             line_search_steps: int = 30
             ) -> Tuple[np.ndarray, float, int]:
    """Returns (x, f(x), iterations). method: 'line_gradient_descent' |
    'conjugate_gradient' | 'lbfgs'. ``value_only``: cheaper loss-only
    evaluator for line-search probes (skips the backward pass)."""
    method = method.lower()
    x = np.asarray(x0, dtype=np.float64).copy()
    f_only = value_only if value_only is not None else (
        lambda xx: value_grad(xx)[0])

    fx, g = value_grad(x)
    it = 0
    prev_g = None
    d_prev = None
    s_hist: List[np.ndarray] = []
    y_hist: List[np.ndarray] = []
    for it in range(1, max_iters + 1):
        gnorm = float(np.linalg.norm(g))
        if gnorm < tol:
            break
        if method == "line_gradient_descent":
            d = -g
        elif method == "conjugate_gradient":
            # Polak-Ribiere+ with automatic restart
            # (ref: ConjugateGradient.java)
            if prev_g is None:
                d = -g
            else:
                beta = max(0.0, float(g @ (g - prev_g))
                           / max(float(prev_g @ prev_g), 1e-300))
                d = -g + beta * d_prev
        elif method == "lbfgs":
            # two-loop recursion (ref: LBFGS.java, memory default 10)
            q = g.copy()
            alphas = []
            for s, y in zip(reversed(s_hist), reversed(y_hist)):
                rho_i = 1.0 / max(float(y @ s), 1e-300)
                a = rho_i * float(s @ q)
                alphas.append((a, rho_i, s, y))
                q -= a * y
            if y_hist:
                y_last, s_last = y_hist[-1], s_hist[-1]
                q *= float(s_last @ y_last) / max(float(y_last @ y_last),
                                                  1e-300)
            for a, rho_i, s, y in reversed(alphas):
                b = rho_i * float(y @ q)
                q += (a - b) * s
            d = -q
        else:
            raise ValueError(f"Unknown optimization algorithm {method!r}")

        step = backtrack_line_search(f_only, x, fx, g, d,
                                     max_steps=line_search_steps)
        if step == 0.0:
            if method == "line_gradient_descent":
                break  # converged (or stuck): steepest descent failed
            # reset curvature info and retry with steepest descent
            s_hist.clear()
            y_hist.clear()
            prev_g = None
            d = -g
            step = backtrack_line_search(f_only, x, fx, g, d,
                                         max_steps=line_search_steps)
            if step == 0.0:
                break
        x_new = x + step * d
        fx_new, g_new = value_grad(x_new)
        if method == "lbfgs":
            s = x_new - x
            y = g_new - g
            if float(s @ y) > 1e-12:
                s_hist.append(s)
                y_hist.append(y)
                if len(s_hist) > history:
                    s_hist.pop(0)
                    y_hist.pop(0)
        prev_g, d_prev = g, d
        converged = abs(fx - fx_new) < tol * (1.0 + abs(fx))
        x, fx, g = x_new, fx_new, g_new
        if converged:
            break
    return x, fx, it


class Solver:
    """Optimize a network's parameters on one dataset with the configured
    algorithm (ref: Solver.java + BaseOptimizer: each ``optimize()`` call
    runs the algorithm against the current batch objective).

    max_iterations: outer algorithm iterations (ref: conf.iterations);
    the per-iteration Armijo backtracking is capped by the conf's
    maxNumLineSearchIterations.

    The params travel as one float64 host vector in JAX's leaf order
    (``tree_leaves``: per layer, param names sorted), written into the
    net's own tensors (in their dtype, on their device) for each
    evaluation. Every evaluation of one ``optimize`` call draws the same
    dropout masks: the net's generator is set back to its state at the
    call's start before each, as the JAX solver passes one step key."""

    def __init__(self, net, max_iterations: int = 100):
        self.net = net
        self.max_iterations = max_iterations

    def _layers(self):
        net = self.net
        if hasattr(net, "_layer_nodes"):
            return [net.conf.nodes[n].layer for n in net._layer_nodes]
        return net.layers

    def optimize(self, dataset) -> float:
        from deeplearning4j_tpu_torch.nn.netcommon import value_and_grad
        from deeplearning4j_tpu_torch.nn.updater import (
            mask_frozen, tree_leaves,
        )
        net = self.net
        net._check_init()
        training = net.conf.training
        leaves = tree_leaves(net.params)
        shapes = [t.shape for t in leaves]
        sizes = [t.numel() for t in leaves]
        layers = self._layers()
        is_graph = hasattr(net, "_split")
        batch = net._split(dataset) if is_graph else net._batch(dataset)
        states = net.states
        rng_start = net._rng.get_state()

        def load(x):
            with torch.no_grad():
                for t, chunk, shape in zip(
                        leaves, np.split(x, np.cumsum(sizes)[:-1]), shapes):
                    t.copy_(torch.from_numpy(chunk).reshape(shape))

        def objective(p):
            net._rng.set_state(rng_start)
            if is_graph:
                return net._loss_fn(p, states, *batch, rng=net._rng)
            loss, (new_states, _, _) = net._loss_fn(p, states, *batch,
                                                    rng=net._rng)
            return loss, new_states

        def vg_np(x):
            load(x)
            loss, _, grads = value_and_grad(objective, net.params)
            grads = mask_frozen(grads, layers)
            flat = torch.cat([g.reshape(-1).double() for g in
                              tree_leaves(grads)]) if leaves else \
                torch.zeros(0, dtype=torch.float64)
            return float(loss), flat.cpu().numpy()

        def v_only(x):
            # the line search's probe: the forward alone
            load(x)
            with torch.no_grad():
                return objective(net.params)

        def f_np(x):
            return float(v_only(x)[0])

        flat0 = torch.cat([t.detach().reshape(-1).double()
                           for t in leaves]).cpu().numpy() if leaves else \
            np.zeros(0)
        x, fx, _ = minimize(
            vg_np, flat0, method=training.optimization_algo,
            max_iters=self.max_iterations, value_only=f_np,
            line_search_steps=max(
                5, training.max_num_line_search_iterations))
        # the params at the final point, and the layer states (BN's
        # running statistics) refreshed there: the line-search objective
        # does not carry them out
        _, new_states = v_only(x)
        net.states = new_states
        net.last_grads = None
        net.score_value = fx
        return fx


def solver_fit_batch(net, data) -> float:
    """One fit_batch iteration through the Solver, with the container's
    bookkeeping (iteration count, listeners), shared by both containers
    (ref: BaseOptimizer.java:295-300, the same solver machinery serves
    both)."""
    score = Solver(
        net, max_iterations=max(1, net.conf.training.iterations),
    ).optimize(data)
    net.last_batch_size = data.num_examples()
    net.iteration_count += 1
    for listener in net.listeners:
        listener.iteration_done(net, net.iteration_count, score)
    return score
