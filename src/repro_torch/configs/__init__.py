"""Architecture configs of the port, as in the JAX package's
``repro.configs``: ``get(name)`` returns the module, each module exposes
``full()`` and ``reduced()`` -> :class:`~repro_torch.models.model.ModelConfig`.

Every architecture of the JAX package is ported: the dense family
(tinyllama-1.1b, qwen2-1.5b, deepseek-7b, qwen2-72b), the audio family
(musicgen-medium), the MoE family (dbrx-132b, and deepseek-v2-236b with
MLA attention), the vlm family (llama-3.2-vision-90b), the hybrid family
(recurrentgemma-2b) and the ssm family (xlstm-350m).  An unknown name
raises ``KeyError``.

    configs.full("xlstm-350m")    # 24 layers: 3 x (7 mLSTM + 1 sLSTM)
    configs.reduced("xlstm-350m") # xlstm-smoke: 8 layers, d 64, float32
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
    "llama_3_2_vision_90b",
    "recurrentgemma_2b",
    "xlstm_350m",
]

# CLI ids (hyphenated, as assigned) -> module names
CLI_IDS = {i.replace("_", "-"): i for i in ARCH_IDS}
CLI_IDS.update({
    "qwen2-1.5b": "qwen2_1_5b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
})


def get(name: str):
    mod = CLI_IDS.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(CLI_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def full(name: str):
    return get(name).full()


def reduced(name: str):
    return get(name).reduced()
