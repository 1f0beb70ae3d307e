"""Architecture configs of the port, as in the JAX package's
``repro.configs``: ``get(name)`` returns the module, each module exposes
``full()`` and ``reduced()`` -> :class:`~repro_torch.models.model.ModelConfig`.

Only tinyllama-1.1b is ported (ROADMAP queue 1 item 11, dense GQA); the
other architectures of the JAX package raise until their slice lands.
"""

import importlib

ARCH_IDS = ["tinyllama_1_1b"]

# CLI ids (hyphenated, as assigned) -> module names
CLI_IDS = {"tinyllama-1.1b": "tinyllama_1_1b"}


def get(name: str):
    mod = CLI_IDS.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch yet "
            f"(ROADMAP queue 1 item 11); ported: {sorted(CLI_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def full(name: str):
    return get(name).full()


def reduced(name: str):
    return get(name).reduced()
