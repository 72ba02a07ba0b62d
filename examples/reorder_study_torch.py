"""Ablation study on the PyTorch port: reordering algorithms x community
strength (the paper's central mechanism isolated), as
``examples/reorder_study.py`` runs it on the JAX package.  Shows the null
result on community-free graphs — reordering exploits structure, it does
not invent it.  Host numpy only: the graphs, the reorders, the G-D cache
model and the shared-set plans print the reference's numbers.

  PYTHONPATH=src python examples/reorder_study_torch.py
"""
from repro_torch.core import REORDERINGS, build_shared_plan, simulate_gd
from repro_torch.graph import DatasetSpec, synthesize


def main():
    print(f"{'community':>10} {'order':>10} {'traffic MB':>11} "
          f"{'hit rate':>9} {'CR saved':>9}")
    for community in (0.0, 0.5, 0.9):
        g = synthesize(DatasetSpec("study", 4096, 400_000, 64, 4,
                                   community=community,
                                   num_communities=16, seed=3))
        for name in ("index", "degree", "bfs", "minhash"):
            gg = g.permute(REORDERINGS[name](g))
            rep = simulate_gd(gg, 64, 128 << 10, 64)
            plan = build_shared_plan(gg)
            print(f"{community:>10} {name:>10} "
                  f"{rep.offchip_bytes / 1e6:>11.1f} {rep.hit_rate:>9.3f} "
                  f"{plan.reduction_ratio:>9.3f}")


if __name__ == "__main__":
    main()
