"""Workload and architecture configurations.

The architecture registry is the JAX package's (``repro/configs``): public
ids map to one module each, and each module exports ``CONFIG`` (the public
configuration) and ``SMOKE_CONFIG`` (a reduced same-family config for CPU
tests).  The port has the modules of the models it runs; any other id
raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that brings
it, and never falls back to another config.
"""
import importlib

# public ids (spec spelling) → module names
ARCH_IDS = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "deepseek-67b": "deepseek_67b",
    "command-r-plus-104b": "command_r_plus_104b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma3-4b": "gemma3_4b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "internvl2-26b": "internvl2_26b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-2.7b": "zamba2_2_7b",
    "totem-rmat": "totem_rmat",
}

# the modules the port has
PORTED = ("tinyllama_1_1b", "gemma3_4b", "deepseek_67b",
          "command_r_plus_104b", "olmoe_1b_7b", "qwen3_moe_235b_a22b",
          "seamless_m4t_large_v2", "internvl2_26b", "xlstm_125m",
          "zamba2_2_7b", "totem_rmat")


def _module(arch_id: str):
    name = ARCH_IDS[arch_id]
    if name not in PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP.md Queue 1 item 15 brings "
            f"the other configs and families")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch_id: str):
    """Load CONFIG by public id (e.g. ``--arch tinyllama-1.1b``)."""
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _module(arch_id).SMOKE_CONFIG


def all_ids():
    """The architecture ids (``totem-rmat``, the graph workload, aside)."""
    return [k for k in ARCH_IDS if k != "totem-rmat"]
