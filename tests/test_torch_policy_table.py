"""The port's PolicyTable / QuantPolicy JSON, parse errors, and the
config side (``apply_policy_table``, uniform collapse, ``layer_cfg``);
mirrors tests/test_policy_table.py, with the JSON of every table held
byte-equal to the JAX package's."""
import dataclasses

import pytest

from repro_torch.core import PolicyTable, QuantPolicy, QuantSpec
from repro_torch.models import apply_policy_table, load_reduced

KV8 = "kv=int8@32:ocp"
KV4 = "kv=e2m1@32:ocp"

# (default, overrides) of every table the cases build
TABLES = {
    "kv8-kv4": (KV8, {1: KV4}),
    "uniform": (KV8, {0: KV8, 3: KV8}),
    "default-only": (KV8, {}),
    "three-formats": (KV8, {1: KV4, 3: "kv_key=e4m3@32:ocp,"
                                       "kv_value=e2m1@32:ocp"}),
    "weights-and-kv": ("weights=e4m3@32:ocp,kv=int8@32:ocp",
                       {2: "weights=e2m1@32:ocp,kv_key=e3m2@32:ocp,"
                           "kv_value=e2m3@32:ocp",
                        5: "weights=int8@16:paper+unpacked,"
                           "kv=e5m2@32:paper"}),
    "fp-default": ("none", {1: KV4}),
}


def _jax_table(default, overrides):
    from repro.core import PolicyTable as JTable
    return JTable(default, overrides)


# =============================================================================
# construction + accessors
# =============================================================================
def test_table_construction_and_lookup():
    t = PolicyTable(KV8, {1: KV4})
    assert t.layer(0) == QuantPolicy.parse(KV8)
    assert t.layer(1) == QuantPolicy.parse(KV4)
    assert t.layer(7) == t.default
    assert t.spec("kv_key", 1) == QuantSpec("e2m1", "ocp", 32)
    assert t.spec("kv_key", 0).fmt == "int8"
    assert not t.is_uniform
    assert t.collapse() is t


def test_table_uniform_collapse():
    t = PolicyTable(KV8, {0: KV8, 3: KV8})
    assert t.is_uniform
    assert t.collapse() == QuantPolicy.parse(KV8)
    assert PolicyTable(KV8).collapse() == QuantPolicy.parse(KV8)


def test_table_is_hashable_and_ordered():
    a = PolicyTable(KV8, {2: KV4, 1: KV4})
    b = PolicyTable(KV8, ((1, QuantPolicy.parse(KV4)),
                          (2, QuantPolicy.parse(KV4))))
    assert a == b and hash(a) == hash(b)
    assert [i for i, _ in a.overrides] == [1, 2]


@pytest.mark.parametrize("make, exc, match", [
    (lambda: PolicyTable(KV8, {-1: KV4}), ValueError, "non-negative"),
    (lambda: PolicyTable(KV8, ((1, QuantPolicy.parse(KV4)),
                               (1, QuantPolicy.parse(KV8)))),
     ValueError, "twice"),
    (lambda: PolicyTable(KV8, {0: 42}), TypeError, "QuantPolicy"),
    (lambda: PolicyTable(default=3.14), TypeError, "QuantPolicy"),
], ids=["negative", "twice", "bad-entry", "bad-default"])
def test_table_construction_errors(make, exc, match):
    with pytest.raises(exc, match=match):
        make()


# =============================================================================
# JSON round trip, byte-equal to the JAX package, and precise errors
# =============================================================================
def test_policy_json_roundtrip():
    p = QuantPolicy.parse("kv_key=int8@32:ocp,kv_value=e2m1@32:ocp,"
                          "weights=e4m3@16:paper+unpacked")
    assert QuantPolicy.from_json_dict(p.to_json_dict()) == p
    assert QuantPolicy.from_json_dict({}) == QuantPolicy()


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_json_roundtrip_and_matches_jax(name):
    t = PolicyTable(*TABLES[name])
    assert PolicyTable.from_json(t.to_json()) == t
    assert PolicyTable.from_json_dict(t.to_json_dict()) == t
    jt = _jax_table(*TABLES[name])
    assert t.to_json() == jt.to_json()
    # each side reads the other's JSON to an equal table
    assert PolicyTable.from_json(jt.to_json()) == t
    assert type(jt).from_json(t.to_json()) == jt


@pytest.mark.parametrize("doc, match", [
    ({"kv_key": "e9m9@32", "kv_value": "int8"}, r"role 'kv_key'.*'e9m9@32'"),
    ({"zz": "int8"}, "unknown tensor role 'zz'"),
    ({"kv_key": 8, "kv_value": "int8"}, "spec string"),
    ({"kv_key": "int8"}, "kv_key and kv_value"),
], ids=["bad-spec", "bad-role", "not-a-string", "half-kv"])
def test_policy_json_errors_name_role_and_spec(doc, match):
    with pytest.raises(ValueError, match=match):
        QuantPolicy.from_json_dict(doc)


@pytest.mark.parametrize("load, match", [
    (lambda: PolicyTable.from_json(
        '{"schema": "policy_table/v1", "default": {"kv_key": "int8", '
        '"kv_value": "int8"}, "layers": {"2": {"kv_key": "e9m9", '
        '"kv_value": "int8"}}}'), r"layer 2.*role 'kv_key'.*'e9m9'"),
    (lambda: PolicyTable.from_json_dict(
        {"schema": "policy_table/v1", "layers": {"x": {}}}),
     "bad layer index 'x'"),
    (lambda: PolicyTable.from_json_dict({"schema": "policy_table/v9"}),
     "schema"),
    (lambda: PolicyTable.from_json_dict(
        {"schema": "policy_table/v1", "extra": 1}), "unknown field"),
    (lambda: PolicyTable.from_json("{nope"), "invalid JSON"),
], ids=["bad-layer-spec", "bad-index", "schema", "extra-field", "bad-json"])
def test_table_json_errors_name_layer_role_spec(load, match):
    with pytest.raises(ValueError, match=match):
        load()


# =============================================================================
# apply_policy_table
# =============================================================================
def test_apply_collapses_uniform_to_plain_policy():
    cfg = load_reduced("chatglm3_6b")
    out = apply_policy_table(cfg, PolicyTable(KV8, {0: KV8, 1: KV8}))
    assert out.mx_table is None
    assert out == load_reduced("chatglm3_6b", mx=QuantPolicy.parse(KV8))
    assert apply_policy_table(cfg, QuantPolicy.parse(KV4)) \
        == load_reduced("chatglm3_6b", mx=QuantPolicy.parse(KV4))


def test_apply_non_uniform_sets_table_and_layer_policies():
    cfg = load_reduced("chatglm3_6b")
    out = apply_policy_table(cfg, PolicyTable(KV8, {1: KV4}))
    assert out.mx_table is not None
    assert out.mx == QuantPolicy.parse(KV8)        # mirrors the default
    assert out.layer_policy(0).kv_key.fmt == "int8"
    assert out.layer_policy(1).kv_key.fmt == "e2m1"
    assert out.layer_cfg(1).mx_table is None
    assert out.layer_cfg(1).mx == QuantPolicy.parse(KV4)
    assert cfg.layer_cfg(1) is cfg                 # no table: itself


def test_apply_rejects_out_of_range_layers_and_non_decoder():
    cfg = load_reduced("chatglm3_6b")
    with pytest.raises(ValueError, match=r"layer\(s\) \[9\]"):
        apply_policy_table(cfg, PolicyTable(KV8, {9: KV4}))
    other = dataclasses.replace(cfg, family="rwkv")
    with pytest.raises(NotImplementedError, match="decoder"):
        apply_policy_table(other, PolicyTable(KV8, {1: KV4}))
    # uniform tables are fine on any family (they collapse)
    assert apply_policy_table(other, PolicyTable(KV8)).mx_table is None
    with pytest.raises(TypeError, match="PolicyTable or QuantPolicy"):
        apply_policy_table(cfg, KV8)


def test_apply_matches_jax_layer_policies():
    """Layer by layer, the port's config under a table carries the JAX
    config's policy (by JSON)."""
    from repro.models import apply_policy_table as j_apply
    from repro.models import load_reduced as j_load_reduced
    default, over = TABLES["weights-and-kv"]
    jcfg = j_apply(j_load_reduced("chatglm3_6b", n_layers=6),
                   _jax_table(default, over))
    cfg = apply_policy_table(load_reduced("chatglm3_6b", n_layers=6),
                             PolicyTable(default, over))
    for i in range(6):
        assert cfg.layer_policy(i).to_json_dict() \
            == jcfg.layer_policy(i).to_json_dict()
