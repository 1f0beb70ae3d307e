"""The program's parameter tree for the decoder configurations, built
from the benchmark's named leaves (``reference/decoder.py``'s
``leaf_specs``) as views of the same tensors, and read back by name.

One segment of ``("dense",)`` or ``("moe",)`` blocks, stacked over the
layers: ``{"embed", "final_norm": {"scale"}, "lm_head"?, "segments":
[{"b0_<kind>": {"ln1": {"scale"}, "attn": {"wq", ...}, "ln2":
{"scale"}, "mlp" | "moe": {...}}}]}``."""

from __future__ import annotations

ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
MOE = ("router", "wg", "wu", "wd")
MLP = ("wg", "wu", "wd")


def _block_key(m: dict) -> tuple[str, str]:
    return ("b0_moe", "moe") if m.get("moe") else ("b0_dense", "mlp")


def port_tree(m: dict, named: dict) -> dict:
    """The program's tree over the tensors of ``named``."""
    key, ffn = _block_key(m)
    block = {"ln1": {"scale": named["ln1"]},
             "attn": {k: named[k] for k in ATTN if k in named},
             "ln2": {"scale": named["ln2"]},
             ffn: {k: named[k] for k in (MOE if ffn == "moe" else MLP)}}
    tree = {"embed": named["embed"],
            "final_norm": {"scale": named["final_norm"]},
            "segments": [{key: block}]}
    if "lm_head" in named:
        tree["lm_head"] = named["lm_head"]
    return tree


def named(m: dict, tree: dict) -> dict:
    """``name -> tensor`` of the program's tree (any tree of its
    structure: parameters, gradients, a moment of the optimizer)."""
    key, ffn = _block_key(m)
    block = tree["segments"][0][key]
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]["scale"],
           "ln1": block["ln1"]["scale"], "ln2": block["ln2"]["scale"]}
    out.update(block["attn"])
    out.update(block[ffn])
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    return out
