"""Architecture configs of the port (public literature; see each file).

``get_config(name)`` returns the full-scale :class:`ModelConfig`;
``get_config(name).reduced()`` the CPU test variant.  The dense
decoders (minicpm-2b, stablelm-3b, glm4-9b, llama3-8b), the SSM and
hybrid decoders (mamba2-130m, jamba-1.5-large-398b) and the MoE decoders
(deepseek-moe-16b, mixtral-8x7b) are ported, in the reference package's
order; its VLM and enc-dec architectures (qwen2-vl-7b,
seamless-m4t-medium) raise until their modules are ported (ROADMAP
queue 1, item 7).
"""

from importlib import import_module

ARCHS = ("minicpm-2b", "stablelm-3b", "glm4-9b", "llama3-8b",
         "mamba2-130m", "jamba-1.5-large-398b", "deepseek-moe-16b",
         "mixtral-8x7b")


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet "
                       f"(ROADMAP queue 1, item 7); ported: {ARCHS}")
    mod = import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
