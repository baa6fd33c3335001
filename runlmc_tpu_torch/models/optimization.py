"""AdaDelta optimizer with the reference's custom stopping rule (host
numpy copy of runlmc_tpu/models/optimization.py).

The reference drives climin's Adadelta through paramz
(runlmc/models/optimization.py:13-83). Both the update rule
(climin-style Adadelta with a Nesterov-like momentum pre-step) and the
stopping rule (rolling-max infinity-norm gradient with permitted drops,
optimization.py:59-83) are reproduced here over flat numpy vectors; the
gradient oracle, or the chunk of steps, is supplied by the model and
runs on the device.

Defaults match the reference: step_rate=1, decay=0.9, momentum=0.5,
offset=1e-4, max_it=100, min_grad_ratio=0.1, permitted_drops=5.
"""

import logging

import numpy as np

_LOG = logging.getLogger(__name__)

EVAL_NORM = np.inf  # parity: InterpolatedLLGP.EVAL_NORM


def _noop():
    pass


class AdaDelta:
    def __init__(
        self,
        step_rate=1.0,
        decay=0.9,
        momentum=0.5,
        offset=1e-4,
        max_it=100,
        verbosity=0,
        min_grad_ratio=0.1,
        permitted_drops=5,
        callback=_noop,
    ):
        self.step_rate = step_rate
        self.decay = decay
        self.momentum = momentum
        self.offset = offset
        self.max_it = max_it
        self.verbosity = verbosity
        self.min_grad_ratio = min_grad_ratio
        self.permitted_drops = permitted_drops
        self.callback = callback

    def minimize(self, x0, fprime, state=None):
        """Minimize an objective given only its gradient ``fprime(x)``.

        Returns (x_opt, info dict with n_iter / final grad norm /
        grad-norm history / resumable ``state``).

        ``state``: optional dict from a previous run's
        ``info['state']`` (or a loaded checkpoint's ``opt_state``) —
        resumes the running moments and the stopping rule exactly where
        the interrupted run left off. ``x0`` should then be the
        checkpointed parameter vector.
        """
        x = np.array(x0, dtype=float, copy=True)
        if state is not None:
            gms = np.array(state["gms"], dtype=float, copy=True)
            sms = np.array(state["sms"], dtype=float, copy=True)
            step = np.array(state["step"], dtype=float, copy=True)
            rolling_max = float(state["rolling_max"])
            drops = int(state["drops"])
            n_iter = int(state["n_iter"])
        else:
            gms = np.zeros_like(x)  # running mean of squared gradients
            sms = np.zeros_like(x)  # running mean of squared steps
            step = np.zeros_like(x)
            rolling_max = 0.0
            drops = self.permitted_drops
            n_iter = 0
        grad_norms = []

        if self.verbosity:
            print("starting adadelta", vars(self))
        printing_delta = (
            max(self.max_it // self.verbosity, 1) if self.verbosity else 0
        )

        while True:
            # Momentum pre-step (Nesterov style), gradient at the
            # shifted point, then the adadelta-scaled step.
            step1 = step * self.momentum
            x -= step1

            grad = np.asarray(fprime(x), dtype=float)

            gms = self.decay * gms + (1.0 - self.decay) * grad**2
            step2 = (
                np.sqrt(sms + self.offset)
                / np.sqrt(gms + self.offset)
                * grad
                * self.step_rate
            )
            x -= step2
            step = step1 + step2
            sms = self.decay * sms + (1.0 - self.decay) * step**2
            n_iter += 1

            grad_norm = float(np.linalg.norm(grad, EVAL_NORM))
            grad_norms.append(grad_norm)
            rolling_max = max(grad_norm, rolling_max)

            if self.verbosity and n_iter % printing_delta == 0:
                print(
                    "iteration {:8d} grad norm {:10.4e}".format(
                        n_iter, grad_norm
                    )
                )
            self.callback()

            if grad_norm < self.min_grad_ratio * rolling_max:
                drops -= 1

            if n_iter >= self.max_it or drops <= 0:
                break

        if self.verbosity:
            print(
                "finished adadelta optimization\n"
                "    {:10d} iterations\n"
                "    {:10.4e} final grad norm".format(n_iter, grad_norm)
            )
        return x, {
            "n_iter": n_iter,
            "grad_norm": grad_norm,
            "grad_norms": grad_norms,
            "state": {
                "gms": gms,
                "sms": sms,
                "step": step,
                "rolling_max": rolling_max,
                "drops": drops,
                "n_iter": n_iter,
            },
        }

    def minimize_chunked(self, x0, run_chunk, state=None):
        """Minimize with a DEVICE-side chunked gradient/update loop.

        ``run_chunk(x, gms, sms, step, start_iter)`` performs a fixed
        number of full AdaDelta iterations on device (the update rule
        itself runs there — the chunk length is whatever the oracle
        returns) and returns per-step
        numpy arrays ``(xs, gmss, smss, steps, grad_norms)`` each
        stacked over the chunk. The host replays the reference's exact
        stopping rule (rolling-max infinity-norm + permitted drops,
        runlmc/models/optimization.py:59-83) over the per-step gradient
        norms and, when the stop lands mid-chunk, rewinds to that
        step's parameters/state — given the same gradient-oracle
        stream, the iterate sequence is identical to :meth:`minimize`
        at ~chunk-length fewer host round-trips.
        """
        x = np.array(x0, dtype=float, copy=True)
        if state is not None:
            gms = np.array(state["gms"], dtype=float, copy=True)
            sms = np.array(state["sms"], dtype=float, copy=True)
            step = np.array(state["step"], dtype=float, copy=True)
            rolling_max = float(state["rolling_max"])
            drops = int(state["drops"])
            n_iter = int(state["n_iter"])
        else:
            gms = np.zeros_like(x)
            sms = np.zeros_like(x)
            step = np.zeros_like(x)
            rolling_max = 0.0
            drops = self.permitted_drops
            n_iter = 0
        grad_norms = []
        if self.verbosity:
            print("starting adadelta", vars(self))
        printing_delta = (
            max(self.max_it // self.verbosity, 1) if self.verbosity else 0
        )
        import inspect

        accepts_probe = (
            "stop_probe" in inspect.signature(run_chunk).parameters
        )

        stop = False
        while not stop:
            def stop_probe(gns_prefix, _rm=rolling_max, _dr=drops,
                           _ni=n_iter):
                """Replay the stopping rule over a prefix of certified
                grad norms: returns the 0-based chunk index at which
                training stops, or None. Lets the oracle skip
                expensive rescue work on steps that fall beyond the
                stop point (they are discarded by this loop anyway)."""
                rm, dr, ni = _rm, _dr, _ni
                for j, gn in enumerate(gns_prefix):
                    ni += 1
                    rm = max(float(gn), rm)
                    if float(gn) < self.min_grad_ratio * rm:
                        dr -= 1
                    if ni >= self.max_it or dr <= 0:
                        return j
                return None

            if accepts_probe:
                out = run_chunk(
                    x, gms, sms, step, n_iter, stop_probe=stop_probe
                )
            else:
                out = run_chunk(x, gms, sms, step, n_iter)
            xs, gmss, smss, steps, gns = out
            j_last = len(gns) - 1
            for j, gn in enumerate(np.asarray(gns, dtype=float)):
                n_iter += 1
                gn = float(gn)
                grad_norms.append(gn)
                rolling_max = max(gn, rolling_max)
                if self.verbosity and n_iter % printing_delta == 0:
                    print(
                        "iteration {:8d} grad norm {:10.4e}".format(
                            n_iter, gn
                        )
                    )
                self.callback()
                if gn < self.min_grad_ratio * rolling_max:
                    drops -= 1
                if n_iter >= self.max_it or drops <= 0:
                    stop = True
                    j_last = j
                    break
            x = np.asarray(xs[j_last], dtype=float)
            gms = np.asarray(gmss[j_last], dtype=float)
            sms = np.asarray(smss[j_last], dtype=float)
            step = np.asarray(steps[j_last], dtype=float)

        if self.verbosity:
            print(
                "finished adadelta optimization\n"
                "    {:10d} iterations\n"
                "    {:10.4e} final grad norm".format(
                    n_iter, grad_norms[-1]
                )
            )
        return x, {
            "n_iter": n_iter,
            "grad_norm": grad_norms[-1],
            "grad_norms": grad_norms,
            "state": {
                "gms": gms,
                "sms": sms,
                "step": step,
                "rolling_max": rolling_max,
                "drops": drops,
                "n_iter": n_iter,
            },
        }
