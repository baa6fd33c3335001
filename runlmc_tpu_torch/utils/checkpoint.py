"""Checkpoint and resume (parity: runlmc_tpu/utils/checkpoint.py).

One ``.npz`` file holds what resuming a model's training needs. Both
packages read it: the file's keys are the JAX package's, each with its
dtype and shape, plus keys of the port's own under ``torch__``, which the
JAX package's ``load_checkpoint`` drops.

The JAX package's keys:

- ``format_version``: :data:`FORMAT_VERSION`;
- ``param_array``: the flat raw-parameter vector, in ``ravel_pytree``
  order;
- ``rng_key``: a ``uint32[2]`` PRNG key. The port has no JAX key: it
  writes the layout of ``jax.random.PRNGKey(seed)`` for the model's seed
  (:func:`prng_key`), which the JAX package's ``restore_model`` takes as
  its model key;
- ``norm_means``, ``norm_stds``: the per-output normalizer statistics;
- ``opt__*``: the optimizer state of ``optimize``'s ``info["state"]``
  (AdaDelta's ``gms``, ``sms``, ``step``, ``rolling_max``, ``drops`` and
  ``n_iter``, the same names in both packages). Its ``rng_key`` is the
  port's int run seed of the probe stream; the file stores it as
  ``opt__rng_key`` in the ``uint32[2]`` layout of
  ``jax.random.PRNGKey(run_seed)`` (the JAX package's ``optimize`` reads
  that key as its run key) and as the int64 ``torch__run_seed``;
- ``extra__*``: the caller's extras.

The port's keys (``torch__*``), each a numeric or string array, never an
object array (``np.load`` refuses pickles):

- ``run_seed``: the int64 run seed of the probe stream (see above);
- ``seed_rng``: the state of the model's run-seed generator
  (``_seed_rng``, a numpy ``Generator``), as a JSON string;
- the escalation state: ``objective``, ``exact_precision`` (strings),
  ``equilibrate`` (-1 for None, 0 or 1), ``equilibrate_flip_tried``,
  ``auto_exact_guard`` (bools);
- ``priors``: the priors set by ``set_prior``, as a JSON string.

Resume = :func:`load_checkpoint` + :func:`restore_model` +
``optimize(state=ckpt["opt_state"])``. From a checkpoint taken at a
chunk boundary the resumed run continues bit for bit: the stochastic
probes are seeded per (run seed, global iteration). A file the JAX
package wrote restores the parameters, the normalizers and the
optimizer's moments and stopping state, but its PRNG keys cannot
continue the port's probe stream: the port keeps its own, with a
warning.
"""

import dataclasses
import json
import warnings

import numpy as np

from runlmc_tpu_torch import priors as _priors

FORMAT_VERSION = 1

_MODEL_KEYS = ("param_array", "rng_key", "norm_means", "norm_stds")
_PORT = "torch__"
# the escalation state: (attribute, file key)
_ESCALATION = (("objective", "objective"),
               ("exact_precision", "exact_precision"),
               ("_equilibrate_flip_tried", "equilibrate_flip_tried"),
               ("_auto_exact_guard", "auto_exact_guard"))


def prng_key(seed):
    """The ``uint32[2]`` words of ``jax.random.PRNGKey(seed)`` (the
    threefry layout: the seed's high and low 32 bits)."""
    seed = int(seed)
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                      dtype=np.uint32)


def is_jax_key(key):
    """True for a ``uint32[2]`` PRNG key of the JAX package."""
    k = np.asarray(key)
    return k.shape == (2,) and k.dtype == np.uint32


def warn_foreign_key(what):
    warnings.warn(
        "%s: the PRNG key was written by the JAX package; the port cannot "
        "continue JAX's probe stream and keeps its own run-seed stream"
        % what, RuntimeWarning, stacklevel=3)


# the priors a checkpoint may name: a file names a class by its name and
# nothing else of the priors module is reachable from it
_PRIOR_CLASSES = {cls.__name__: cls for cls in (
    _priors.Gaussian, _priors.Gamma, _priors.InverseGamma,
    _priors.HalfLaplace)}


def _prior_from_json(p):
    """The prior of one entry of the ``priors`` JSON; ValueError for a
    class not in ``_PRIOR_CLASSES`` or arguments other than its numeric
    fields."""
    cls = _PRIOR_CLASSES.get(p.get("prior"))
    if cls is None:
        raise ValueError("checkpoint names an unknown prior %r"
                         % (p.get("prior"),))
    args = p.get("args")
    fields = {f.name for f in dataclasses.fields(cls)}
    if (not isinstance(args, dict) or set(args) != fields
            or not all(isinstance(v, (int, float))
                       and not isinstance(v, bool) for v in args.values())):
        raise ValueError("checkpoint gives prior %s the arguments %r, not "
                         "numbers for %s" % (cls.__name__, args,
                                             sorted(fields)))
    return cls(**args)


def _prior_json(prior_specs):
    return json.dumps([
        {"path": list(path), "prior": type(prior).__name__,
         "args": dataclasses.asdict(prior)}
        for path, prior, _ in prior_specs
    ])


def checkpoint_state(model, opt_state=None, extra=None):
    """Collect a model's resumable state into a flat dict of arrays (the
    keys of the module docstring)."""
    state = {
        "format_version": np.asarray(FORMAT_VERSION),
        "param_array": np.asarray(model.param_array),
        "rng_key": prng_key(model.seed),
        "norm_means": np.asarray(
            [norm.mean for norm in model.normalizer], dtype=float
        ),
        "norm_stds": np.asarray(
            [norm.std for norm in model.normalizer], dtype=float
        ),
    }
    if opt_state is not None:
        for k, v in opt_state.items():
            if k == "rng_key" and not is_jax_key(v):
                run_seed = int(np.asarray(v).reshape(()))
                state["opt__rng_key"] = prng_key(run_seed)
                state[_PORT + "run_seed"] = np.asarray(run_seed,
                                                       dtype=np.int64)
            else:
                state["opt__" + k] = np.asarray(v)
    if extra is not None:
        for k, v in extra.items():
            state["extra__" + k] = np.asarray(v)
    if hasattr(model, "_seed_rng"):
        state[_PORT + "seed_rng"] = np.asarray(
            json.dumps(model._seed_rng.bit_generator.state))
    for attr, key in _ESCALATION:
        if hasattr(model, attr):
            state[_PORT + key] = np.asarray(getattr(model, attr))
    if hasattr(model, "_equilibrate"):
        eq = model._equilibrate
        state[_PORT + "equilibrate"] = np.asarray(
            -1 if eq is None else int(eq), dtype=np.int8)
    if hasattr(model, "_prior_specs"):
        state[_PORT + "priors"] = np.asarray(_prior_json(model._prior_specs))
    return state


def save_checkpoint(path, model, opt_state=None, extra=None):
    """Write a single-file ``.npz`` checkpoint of ``model`` (+ optional
    optimizer state from ``optimize``'s ``info['state']`` and user
    extras)."""
    np.savez_compressed(
        path, **checkpoint_state(model, opt_state=opt_state, extra=extra)
    )


def load_checkpoint(path):
    """Read a checkpoint into a dict with keys ``param_array``,
    ``rng_key``, ``norm_means``, ``norm_stds``, plus nested
    ``opt_state`` / ``extra`` dicts when present and, for a file the port
    wrote, ``torch`` (its own keys without the prefix). The
    ``opt_state`` of a port file carries the int64 run seed as its
    ``rng_key``; that of a JAX file, JAX's ``uint32[2]`` key."""
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    version = int(raw.pop("format_version", 1))
    if version > FORMAT_VERSION:
        raise ValueError(
            "checkpoint format %d newer than supported %d"
            % (version, FORMAT_VERSION)
        )
    out = {k: raw[k] for k in _MODEL_KEYS if k in raw}
    opt = {
        k[len("opt__"):]: v for k, v in raw.items()
        if k.startswith("opt__")
    }
    extra = {
        k[len("extra__"):]: v for k, v in raw.items()
        if k.startswith("extra__")
    }
    port = {
        k[len(_PORT):]: v for k, v in raw.items() if k.startswith(_PORT)
    }
    if "run_seed" in port:
        opt["rng_key"] = port.pop("run_seed")
    if opt:
        out["opt_state"] = opt
    if extra:
        out["extra"] = extra
    if port:
        out["torch"] = port
    return out


def _restore_port_state(model, port):
    if "seed_rng" in port and hasattr(model, "_seed_rng"):
        rng = np.random.default_rng()
        rng.bit_generator.state = json.loads(str(port["seed_rng"]))
        model._seed_rng = rng
    for attr, key in _ESCALATION:
        if key in port and hasattr(model, attr):
            v = port[key]
            setattr(model, attr, bool(v) if v.dtype == bool else str(v))
    if "equilibrate" in port and hasattr(model, "_equilibrate"):
        eq = int(port["equilibrate"])
        model._equilibrate = None if eq < 0 else bool(eq)
    if "priors" in port and hasattr(model, "_prior_specs"):
        specs = []
        for p in json.loads(str(port["priors"])):
            path = tuple(p["path"])
            prior = _prior_from_json(p)
            transform = model._transform_for_path(path)
            _priors.check_domain(prior, transform)
            specs.append((path, prior, transform))
        model._prior_specs = specs
    if hasattr(model, "_bump"):
        model._bump()


def restore_model(model, ckpt):
    """Restore a model's parameters, normalizer statistics and, from a
    file the port wrote, its run-seed generator, escalation state and
    priors, from a loaded checkpoint dict (see :func:`load_checkpoint`).
    The parameters land on the model's own device.

    The model must have been constructed with the same kernel spec (the
    parameter count is checked)."""
    x = np.asarray(ckpt["param_array"])
    n_expected = getattr(model, "n_params", len(model.param_array))
    if x.shape != (n_expected,):
        raise ValueError(
            "checkpoint has %d parameters, model expects %d"
            % (x.shape[0] if x.ndim else 1, n_expected)
        )
    model.param_array = x
    means = ckpt.get("norm_means")
    stds = ckpt.get("norm_stds")
    if means is not None and len(means) == len(model.normalizer):
        for norm, mu, sd in zip(model.normalizer, means, stds):
            norm.mean = float(mu)
            norm.std = float(sd)
    if "torch" in ckpt:
        _restore_port_state(model, ckpt["torch"])
    elif hasattr(model, "_seed_rng"):
        warn_foreign_key("restore_model")
    return model
