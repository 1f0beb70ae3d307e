"""Architecture configs of the port, as in the JAX package's
``repro.configs``: ``get(name)`` returns the module, each module exposes
``full()`` and ``reduced()`` -> :class:`~repro_torch.models.model.ModelConfig`.

Ported: the dense family (tinyllama-1.1b, qwen2-1.5b, deepseek-7b,
qwen2-72b), the audio family (musicgen-medium) and the MoE family
(dbrx-132b, and deepseek-v2-236b with MLA attention).  The other
architectures of the JAX package raise until their slice lands (ROADMAP
queue 1, modules to port).
"""

import importlib

ARCH_IDS = [
    "qwen2_1_5b",
    "tinyllama_1_1b",
    "deepseek_7b",
    "qwen2_72b",
    "musicgen_medium",
    "dbrx_132b",
    "deepseek_v2_236b",
]

# CLI ids (hyphenated, as assigned) -> module names
CLI_IDS = {i.replace("_", "-"): i for i in ARCH_IDS}
CLI_IDS.update({
    "qwen2-1.5b": "qwen2_1_5b",
    "tinyllama-1.1b": "tinyllama_1_1b",
})


def get(name: str):
    mod = CLI_IDS.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch yet "
            f"(ROADMAP queue 1, modules to port); ported: "
            f"{sorted(CLI_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def full(name: str):
    return get(name).full()


def reduced(name: str):
    return get(name).reduced()
