"""Checkpoint/resume + mesh training with the PyTorch port, end to end
(the counterpart of examples/checkpoint_and_mesh.py):

1. checkpointing — interrupt training at a chunk boundary (10 steps),
   save one .npz with the optimizer state, restore it into a FRESH
   model, and resume: the final parameters match an uninterrupted run
   bit for bit (the probe stream is keyed by the global iteration);
2. mesh training — the same model over ``runlmc_tpu_torch.parallel``'s
   global mesh, one process per rank, the solve rows (or, for the exact
   objective, the data rows) sharded over the 'probe' axis.

Run on the card (one process):

    python examples/checkpoint_and_mesh_torch.py

or on N ranks with the COORD/NPROC/PROC_ID recipe (one command per rank;
COORD is host:port or a shared file as file:///path):

    COORD=file:///tmp/rdv NPROC=2 PROC_ID=0 python examples/checkpoint_and_mesh_torch.py &
    COORD=file:///tmp/rdv NPROC=2 PROC_ID=1 python examples/checkpoint_and_mesh_torch.py

Add ``--cpu`` to run the kernels' plain PyTorch versions on the CPU
(Gloo between the ranks).
"""

import hashlib
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from runlmc_tpu_torch import (  # noqa: E402
    AdaDelta,
    InterpolatedLLGP,
    LMCKernelSpec,
    RBF,
)
from runlmc_tpu_torch.parallel import global_mesh, initialize  # noqa: E402


def build(device, mesh=None, seed=7):
    rng = np.random.default_rng(0)
    n = 120
    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (n, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n) for X in Xs]
    spec = LMCKernelSpec.create(
        D=2, lmc_kernels=[RBF(name="k")], lmc_ranks=[1]
    )
    return InterpolatedLLGP(
        Xs, Ys, functional_kernel=spec, m=[24], seed=seed, mesh=mesh,
        device=device,
    )


def main(argv):
    device = "cpu" if "--cpu" in argv else None
    # ---- 1. interrupt / checkpoint / resume ------------------------------
    m_full = build(device)
    m_full.optimize(optimizer=AdaDelta(max_it=30))
    x_uninterrupted = m_full.param_array.copy()

    m_a = build(device)
    info_a = m_a.optimize(optimizer=AdaDelta(max_it=10))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        m_a.save(path, opt_state=info_a["state"])
        print("checkpoint written after %d iterations -> %s"
              % (info_a["n_iter"], path))
        m_b = build(device)  # a FRESH model (a new process in real use)
        ckpt = m_b.restore(path)
    m_b.optimize(optimizer=AdaDelta(max_it=30), state=ckpt["opt_state"])
    drift = np.max(np.abs(m_b.param_array - x_uninterrupted))
    print("resumed run vs uninterrupted run: max param drift %.2e" % drift)
    assert drift == 0.0, drift

    # ---- 2. the same model over the global mesh --------------------------
    started = initialize(backend="gloo" if device == "cpu" else None)
    mesh = global_mesh(axis_name="probe")
    m_mesh = build(device, mesh=mesh)
    m_mesh.optimize(optimizer=AdaDelta(max_it=10))
    Xt = [np.linspace(0.5, 5.5, 25)[:, None]] * 2
    mus, vs = m_mesh.predict(Xt)
    err = np.abs(mus[0] - np.sin(Xt[0][:, 0])).mean()
    digest = hashlib.sha256(np.ascontiguousarray(
        m_mesh.param_array).tobytes()).hexdigest()[:16]
    print("mesh (rank %d of %d%s, %s objective) fit: mean abs prediction "
          "error %.3f, parameters sha256 %s"
          % (mesh.rank, mesh.size, "" if started else ", one process",
             m_mesh.objective, err, digest))
    assert err < 0.25


if __name__ == "__main__":
    main(sys.argv[1:])
