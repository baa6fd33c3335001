"""Multi-process runtime entry point (parity:
runlmc_tpu/parallel/launcher.py:50-147).

The JAX package runs ONE SPMD program across every host of a pod slice.
The port runs one process per rank over ``torch.distributed``: every
rank builds the same model with the same mesh and runs the same
sequence of calls; the layouts of the mesh (``parallel/mesh.py``) say
which rows or frequencies each rank holds, and the collectives of
``parallel/collectives.py`` join them.

Single-process use (tests, one card) degenerates to a no-op:
``initialize()`` without arguments or environment leaves
``torch.distributed`` alone, and ``global_mesh`` holds this process.

Launch recipe (one command per rank)::

    COORD=10.0.0.2:8476 NPROC=2 PROC_ID=$i python train.py

or under torchrun (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` play the part
of the TPU pod's auto-discovery)::

    torchrun --nproc-per-node=2 train.py

where ``train.py`` begins::

    import runlmc_tpu_torch.parallel as par
    par.initialize()                      # no-op on a single process
    mesh = par.global_mesh(axis_name="probe")
    model = InterpolatedLLGP(..., mesh=mesh)
    model.optimize()                      # same program at any scale

``COORD`` may also be a full init method (``file:///shared/rendezvous``
or ``tcp://host:port``). The process group's timeout defaults to
``DEFAULT_TIMEOUT_S``, so that a rank that diverges fails instead of
hanging.
"""

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

_LOG = logging.getLogger(__name__)

# seconds a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 120.0

_INITIALIZED = False
_TIMEOUT = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def group_timeout(timeout=None):
    """The timeout of new process groups: ``timeout`` (seconds or a
    timedelta), else the one ``initialize`` started with."""
    if timeout is None:
        return _TIMEOUT
    if isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, timeout=None, **kwargs):
    """Start the process group of a multi-process run (idempotent).

    Arguments default from the environment (``COORD``, ``NPROC``,
    ``PROC_ID``), and under torchrun from its ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR``. When neither arguments nor environment indicate a
    multi-process run this is a no-op, and the program stays a single
    process. ``backend`` defaults to 'nccl' where the rank's device is
    a CUDA card and 'gloo' on the CPU; 'gloo' also runs ranks that share
    one card. ``timeout`` (seconds) defaults to ``DEFAULT_TIMEOUT_S``.
    Extra keyword arguments go to ``dist.init_process_group``.

    Returns True when a process group was started."""
    global _INITIALIZED, _TIMEOUT
    if _INITIALIZED:
        return True
    coordinator_address = coordinator_address or os.environ.get("COORD")
    if num_processes is None and "NPROC" in os.environ:
        num_processes = int(os.environ["NPROC"])
    if process_id is None and "PROC_ID" in os.environ:
        process_id = int(os.environ["PROC_ID"])
    torchrun = (coordinator_address is None and num_processes is None
                and "MASTER_ADDR" in os.environ
                and "WORLD_SIZE" in os.environ and "RANK" in os.environ)
    explicit = coordinator_address is not None and num_processes is not None
    if not (torchrun or explicit):
        _LOG.info("parallel.initialize: single-process run (no coordinator "
                  "configured) — no process group started")
        return False
    if explicit and process_id is None:
        raise ValueError(
            "parallel.initialize: COORD/NPROC set but no process id — "
            "set PROC_ID=<i> (or pass process_id=); TPU pods should "
            "call initialize() with no arguments instead"
        )
    if torchrun:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    from runlmc_tpu_torch.parallel.mesh import rank_device

    device = rank_device(int(os.environ.get("LOCAL_RANK", process_id)))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _TIMEOUT = group_timeout(DEFAULT_TIMEOUT_S if timeout is None
                             else timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=_TIMEOUT,
                            **kwargs)
    _INITIALIZED = True
    _LOG.info("parallel.initialize: rank %d/%d on %s over %s",
              dist.get_rank(), dist.get_world_size(), device, backend)
    return True


def global_mesh(axis_name="probe", grid_axis=None):
    """A mesh over ALL ranks of the running group.

    ``grid_axis``: optional size of a second 'grid' axis (grid-sharded
    fft matvecs); the 'grid' axis runs over consecutive ranks, inside a
    host wherever the launcher numbers a host's ranks together (its
    collectives run at every matvec, while the batch axis has none
    inside the solves)."""
    from runlmc_tpu_torch.parallel.mesh import _world, make_mesh

    _, world = _world()
    ranks = np.arange(world)
    if grid_axis is None or grid_axis == 1:
        return make_mesh(ranks, (axis_name,))
    if world % grid_axis:
        raise ValueError("device count %d not divisible by grid_axis %d"
                         % (world, grid_axis))
    return make_mesh(ranks.reshape(world // grid_axis, grid_axis),
                     (axis_name, "grid"))


def is_distributed():
    return _INITIALIZED
