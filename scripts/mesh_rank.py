"""``chip_smoke.py``'s ``[mesh]`` rank alone, on one card: a tinyllama-1.1b
AdamW step at 2 layers (B=8, S=2048) and a full-depth prefill (B=4,
S=2048) on a ``(1, 1)`` mesh of one NCCL rank, each against the plain
call (``launch/mesh_selftest.py::card_rank``).  Prints the step's and the
prefills' seconds, the flash launches through the custom op and whether
the results are bit for bit the plain ones.

  PYTHONPATH=src python3 scripts/mesh_rank.py [label]

To compare two trees, run it with each tree's ``src`` on ``PYTHONPATH``,
in turns, in one call.
"""
import sys


def main():
    from repro_torch.launch import mesh_selftest
    from repro_torch.launch.world import run_world

    r = run_world(mesh_selftest.card_rank, 1, device="cuda", timeout=200,
                  args=("tinyllama-1.1b", 2, 8, 2048, 4, 2048))[0]
    label = sys.argv[1] if len(sys.argv) > 1 else "mesh"
    print(f"{label}: step_s {r['step_s']} prefill_s {r['prefill_s']:.4f} "
          f"plain_prefill_s {r['plain_prefill_s']:.4f} "
          f"flash {r['flash_launches']} bit_equal {r['bit_equal']}/"
          f"{r['leaves']} logits_equal {r['logits_bit_equal']}", flush=True)


if __name__ == "__main__":
    main()
