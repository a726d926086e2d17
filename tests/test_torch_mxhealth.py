"""MX-health sampling over the paged KV pool against the reference (mirrors
src/repro/obs/mxhealth.py's contract).

``sample_mx_health`` classifies the E8M0 scale bytes of every slot's
live positions per KV role — scale bytes scanned, poison markers (at or
above the mode's threshold), saturated blocks (the largest legal
exponent, ``threshold - 1``) and underflow blocks (code 0).  The same
layer-stacked pool (random scale bytes, with poisoned, saturated and
underflow blocks planted in live and dead positions), block tables and
lengths go through the reference's function and the port's, for every
element format in both modes, K and V of one format and K INT8 with it
as V; the counts must be equal exactly.  An fp pool reports zeros.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.formats import ALL_FORMATS, poison_threshold
from repro_torch.core.spec import QuantPolicy
from repro_torch.models import load_reduced
from repro_torch.models.layers import init_paged_kv_cache
from repro_torch.obs import sample_mx_health, scale_stat_names

torch.set_num_threads(1)

FMTS = [f.name for f in ALL_FORMATS]
LAYERS, PAGES, PAGE, HKV, HD = 2, 24, 8, 2, 64
SLOTS, MAX_PAGES = 4, 5


def _case(policy, seed):
    """(reference cfg, port cfg, pool, block tables, lengths)."""
    from repro.models import load_reduced as j_load_reduced
    from repro.models.config import QuantPolicy as JPolicy
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy))
    tcfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(policy))
    pool = init_paged_kv_cache(tcfg, PAGES, PAGE, HKV, HD, "cpu",
                               layers_dim=(LAYERS,))
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    for name, role in (("ks_pages", "kv_key"), ("vs_pages", "kv_value")):
        leaf = pool.get(name)
        if leaf is None:
            continue
        thr = poison_threshold(getattr(tcfg.mx, role).mode)
        leaf.copy_(torch.randint(100, 140, leaf.shape, generator=g,
                                 dtype=torch.uint8))
        flat = leaf.view(-1)
        for val, n in ((thr, 9), (0xFF, 4), (thr - 1, 11), (0, 13)):
            flat[torch.from_numpy(rng.choice(flat.numel(), n,
                                             replace=False))] = val
    for name in ("kc_pages", "vc_pages", "k_pages", "v_pages"):
        if name in pool:
            pool[name].copy_(torch.randint(0, 255, pool[name].shape,
                                           generator=g).to(pool[name].dtype))
    bt = np.zeros((SLOTS, MAX_PAGES), np.int32)
    perm = rng.permutation(np.arange(1, PAGES))
    lengths = np.array([0, 1, 17, MAX_PAGES * PAGE - 1], np.int32)
    k = 0
    for b, n in enumerate(lengths):
        need = -(-int(n) // PAGE)
        bt[b, :need] = perm[k:k + need]
        k += need
    return jcfg, tcfg, pool, bt, lengths


def _reference(jcfg, pool, bt, lengths):
    import jax.numpy as jnp
    from repro.obs.mxhealth import sample_mx_health as j_sample
    jpool = {"layers": {k: jnp.asarray(v.float().numpy()
                                       if v.dtype == torch.bfloat16
                                       else v.numpy())
                        for k, v in pool.items()}}
    st = j_sample(jpool, jnp.asarray(bt), jnp.asarray(lengths), jcfg)
    return {role: {k: int(v) for k, v in d.items()}
            for role, d in st.items()}


POLICIES = [f"kv={f}@32:{m}" for f in FMTS for m in ("paper", "ocp")] \
    + ["kv_key=int8@32:ocp,kv_value=e2m1@32:ocp",
       "kv_key=int8@32:paper,kv_value=e4m3@32:paper"]


@pytest.mark.parametrize("policy", POLICIES)
def test_sample_mx_health_matches_reference(policy):
    jcfg, tcfg, pool, bt, lengths = _case(policy, len(policy))
    want = _reference(jcfg, pool, bt, lengths)
    got = sample_mx_health(pool, torch.from_numpy(bt),
                           torch.from_numpy(lengths), tcfg)
    assert got == want
    for role in ("kv_key", "kv_value"):
        st = got[role]
        # every live position holds LAYERS x HKV x HD/32 scale bytes
        assert st["scale_bytes"] == int(lengths.sum()) * LAYERS * HKV \
            * (HD // 32)
        assert st["scale_bytes"] > st["poison"] > 0
        assert st["saturated"] > 0 and st["underflow"] > 0


def test_dead_positions_are_not_counted():
    """Markers past a slot's length (and on the trash page) are ignored;
    a marker inside it counts once."""
    jcfg, tcfg, pool, bt, lengths = _case("kv=int8@32:ocp", 1)
    for name in ("ks_pages", "vs_pages"):
        pool[name].fill_(120)
    pool["ks_pages"][:, 0] = 0xFF                # the trash page
    p = int(bt[2, 2])                            # slot 2: 17 positions
    pool["ks_pages"][0, p, 0, 1, 0] = 0xFF       # position 16: live
    pool["ks_pages"][0, p, 1, 1, 0] = 0xFF       # position 17: dead
    got = sample_mx_health(pool, torch.from_numpy(bt),
                           torch.from_numpy(lengths), tcfg)
    assert got == _reference(jcfg, pool, bt, lengths)
    assert got["kv_key"]["poison"] == 1 and got["kv_value"]["poison"] == 0
    assert got["kv_key"]["underflow"] == got["kv_key"]["saturated"] == 0


def test_fp_pool_reports_zeros():
    jcfg, tcfg, pool, bt, lengths = _case("none", 2)
    got = sample_mx_health(pool, torch.from_numpy(bt),
                           torch.from_numpy(lengths), tcfg)
    zero = dict.fromkeys(scale_stat_names, 0)
    assert got == {"kv_key": zero, "kv_value": zero}
    assert got == _reference(jcfg, pool, bt, lengths)
