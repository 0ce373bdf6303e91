"""The port's config registry against ``repro.configs`` for the
configurations of the moe slice (phi3.5-moe-42b, grok-1-314b and the
dense qwen3-4b and phi3-medium-14b) and of the hybrid slice
(jamba-v0.1-52b): full and reduced, field by field (``MoEConfig`` and
``SSMConfig`` through ``dataclasses.asdict``), which layers use MoE and
which are attention, the reduced MoE's dropless capacity, a depth cut,
and the parameter count of the full tree against the reference's
``param_counts``."""
import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import moe
from repro_torch.models.model import LM

NEW = ["phi3.5-moe-42b-a6.6b", "grok-1-314b", "qwen3-4b", "phi3-medium-14b",
       "jamba-v0.1-52b"]


def _fields(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("reduced", [False, True])
def test_new_configs_match_jax(arch, reduced):
    assert arch in ARCH_IDS
    mine, ref = ((reduced_config(arch), jax_reduced_config(arch)) if reduced
                 else (get_config(arch), jax_get_config(arch)))
    got = _fields(mine)
    want = {k: _fields(ref)[k] for k in got}
    assert got == want
    assert [mine.layer_uses_moe(i) for i in range(mine.n_layers)] == \
        [ref.layer_uses_moe(i) for i in range(ref.n_layers)]
    assert [mine.layer_kind(i) for i in range(mine.n_layers)] == \
        [ref.layer_kind(i) for i in range(ref.n_layers)]


@pytest.mark.parametrize("arch", NEW[:2])
def test_reduced_moe_is_dropless_and_cut_depth_matches(arch):
    """capacity_factor = min(E, 4): every choice of a group fits
    (capacity >= top_k x tokens); the full config drops past its
    capacity (phi3.5-moe's 8 x 512 static prefill: 80 a row and expert);
    ``get_config(arch, n_layers=4)`` is the reference's cut."""
    cfg = reduced_config(arch)
    assert cfg.moe.num_experts == 4 and cfg.moe.expert_d_ff == 256
    for sg in (1, 4, 9, 512):
        assert moe._capacity(sg, cfg) >= cfg.moe.top_k * sg
    full = get_config(arch)
    assert moe._capacity(512, full) < full.moe.top_k * 512
    if arch == NEW[0]:
        assert moe._capacity(512, full) == 80
        assert moe._capacity(1, full) == 1
    cut, ref = (_fields(get_config(arch, n_layers=4)),
                _fields(jax_get_config(arch, n_layers=4)))
    assert cut == {k: ref[k] for k in cut} and cut["n_layers"] == 4


@pytest.mark.parametrize("arch", NEW)
def test_init_param_count_matches_reference(arch):
    """The full tree's bytes (reckoned on the meta device) are the
    reference's ``param_counts`` total in bf16, the routers' fp32 counted
    twice: embed, unembed, every layer and the final norm.  A mamba
    layer (jamba's) also holds A_log and D in fp32 (counted twice) and
    dt_bias (fp32, which ``param_counts`` leaves out): 8 bytes a head."""
    cfg = get_config(arch)
    total, _ = jax_get_config(arch).param_counts()
    layers = range(cfg.n_layers)
    router = (sum(cfg.layer_uses_moe(i) for i in layers) * cfg.d_model
              * cfg.moe.num_experts if cfg.moe else 0)
    mamba = sum(cfg.layer_kind(i) == "mamba" for i in layers)
    heads = (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim if cfg.ssm
             else 0)
    assert LM(cfg, device="cpu").init_param_bytes() == \
        2 * total + 2 * router + 8 * heads * mamba
