"""Architecture configs of the port (public literature; see each file).

``get_config(name)`` returns the full-scale :class:`ModelConfig`;
``get_config(name).reduced()`` the CPU test variant.  Every
architecture of the reference package is ported, in its order: the
dense decoders (minicpm-2b, stablelm-3b, glm4-9b, llama3-8b), the SSM
and hybrid decoders (mamba2-130m, jamba-1.5-large-398b), the VLM
backbone (qwen2-vl-7b, M-RoPE), the MoE decoders (deepseek-moe-16b,
mixtral-8x7b) and the enc-dec model (seamless-m4t-medium).
"""

from importlib import import_module

ARCHS = ("minicpm-2b", "stablelm-3b", "glm4-9b", "llama3-8b",
         "mamba2-130m", "jamba-1.5-large-398b", "qwen2-vl-7b",
         "deepseek-moe-16b", "mixtral-8x7b", "seamless-m4t-medium")


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
