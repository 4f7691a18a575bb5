"""Architecture configs of the port (public literature; see each file).

``get_config(name)`` returns the full-scale :class:`ModelConfig`;
``get_config(name).reduced()`` the CPU test variant.  The dense decoder
and the MoE decoders are ported; other architectures of the reference
package raise until their modules are ported (ROADMAP queue 1).
"""

from importlib import import_module

ARCHS = ("llama3-8b", "mixtral-8x7b", "deepseek-moe-16b")


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet "
                       f"(ROADMAP queue 1); ported: {ARCHS}")
    mod = import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
