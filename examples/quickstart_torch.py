"""Quickstart on the PyTorch port: FedSTIL in ~40 lines.

Five edge clients, six sequential tasks of drifting synthetic ReID data,
spatial-temporal knowledge integration on the server, on the host engine;
prints per-round accuracy and the final relevance matrix W (Eq. 5). The
counterpart of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--rounds 12]
      [--device cpu]        # the card by default
"""
import argparse

import numpy as np

from repro_torch.core.edge_model import EdgeModelConfig
from repro_torch.core.fedstil import FedSTIL
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import run_simulation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    # 1. The federated lifelong benchmark (synthetic stand-in for the
    #    paper's five-dataset mixture).
    bench = FederatedReIDBenchmark(n_clients=5, n_tasks=6, n_identities=120,
                                   ids_per_task=12, samples_per_id=8, seed=0)
    # 2. The edge model: frozen extraction layers + FedSTIL-decomposed
    #    adaptive layers (theta = B ⊙ alpha + A, Eq. 2).
    cfg = EdgeModelConfig(n_classes=bench.n_classes)
    # 3. The paper's method.
    strategy = FedSTIL(cfg, n_clients=5, metric="kl", forgetting_ratio=0.5,
                       memory_size=1000, epochs=4)
    # 4. Run the federated lifelong simulation.
    res = run_simulation(strategy, bench, rounds=args.rounds, eval_every=3,
                         verbose=True, engine="host", device=args.device)

    print(f"\nfinal mAP={res.final('mAP'):.4f}  R1={res.final('R1'):.4f}  "
          f"forgetting={res.rounds[-1]['forgetting_mAP']:.4f}")
    print(f"comm: C2S={res.comm.total_c2s/1e6:.1f}MB "
          f"S2C={res.comm.total_s2c/1e6:.1f}MB  "
          f"storage={res.storage_bytes/1e6:.1f}MB")
    print("\nknowledge relevance W (rows=receiving client, Eq. 5):")
    print(np.round(strategy.last_W, 3))
    return res, strategy


if __name__ == "__main__":
    main()
