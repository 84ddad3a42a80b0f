"""Method comparison on the PyTorch port: FedSTIL vs FedAvg vs STL vs EWC
on the same drifting federated ReID streams, with communication accounting
(a miniature of paper Table II / Fig. 8). The counterpart of
``examples/federated_lifelong_reid.py``.

Run:  PYTHONPATH=src python examples/federated_lifelong_reid_torch.py
      [--rounds 12] [--device cpu]        # the card by default
"""
import argparse

from repro_torch.comm.accounting import fmt_bytes
from repro_torch.core.edge_model import EdgeModelConfig
from repro_torch.core.fedstil import FedSTIL
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import FedAvg, run_simulation
from repro_torch.lifelong import EWC, STL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    bench = FederatedReIDBenchmark(n_clients=5, n_tasks=6, n_identities=120,
                                   ids_per_task=12, samples_per_id=8, seed=0)
    cfg = EdgeModelConfig(n_classes=bench.n_classes)
    strategies = [
        STL(cfg, epochs=3),
        EWC(cfg, epochs=3),
        FedAvg(cfg, epochs=3),
        FedSTIL(cfg, n_clients=5, epochs=3),
    ]

    print(f"{'method':10s} {'mAP':>7s} {'R1':>7s} {'forget':>7s} "
          f"{'comm':>9s} {'storage':>9s}")
    results = {}
    for s in strategies:
        res = run_simulation(s, bench, rounds=args.rounds, eval_every=4,
                             engine="host", device=args.device)
        f = res.final_metrics()
        print(f"{s.name:10s} {f['mAP']:7.4f} {f['R1']:7.4f} "
              f"{f['forgetting_mAP']:7.4f} {fmt_bytes(res.comm.total):>9s} "
              f"{fmt_bytes(res.storage_bytes):>9s}")
        results[s.name] = res
    return results


if __name__ == "__main__":
    main()
