"""The unified quantization API: ``QuantSpec`` ("how to quantize one
tensor") and ``QuantPolicy`` ("which spec applies to which tensor role").

A ``QuantSpec`` bundles the paper converter's three parameters — element
format, conversion mode, block size — plus the storage packing preference,
into one frozen, hashable object that can key caches and ride through
config dataclasses.  The string grammar

    fmt[@block][:mode][+packed|+unpacked]

round-trips through ``QuantSpec.parse`` / ``str()``:

    >>> str(QuantSpec.parse("int8@32:ocp"))
    'int8@32:ocp'

``QuantSpec.parse("none")`` returns ``None`` — the fp-passthrough sentinel
(no quantization for that role).

A ``QuantPolicy`` maps the five tensor roles — ``weights``,
``activations``, ``kv_key``, ``kv_value``, ``grads`` — to an optional spec
each, so e.g. INT8 keys can coexist with E2M1 values in the same serving
engine.  Its grammar is a comma-joined list of ``role=spec`` entries (the
shorthand role ``kv`` sets both KV roles):

    >>> QuantPolicy.parse("kv_key=int8@32:ocp,kv_value=e2m1@32:ocp")

The legacy ``MXPolicy`` constructor and the ``fmt=``/``mode=``/``block=``
keyword forms of the public conversion entry points keep working through
deprecation shims built on ``resolve_spec`` (each shimmed entry point
warns exactly once per process).
"""
from __future__ import annotations

import dataclasses
import json
import re
import warnings
from typing import Dict, Mapping, Optional, Tuple, Union

from repro_torch.core.formats import DEFAULT_BLOCK, MXFormat, get_format

MODES: Tuple[str, ...] = ("paper", "ocp")

# tensor roles a QuantPolicy can address, in canonical order
ROLES: Tuple[str, ...] = ("weights", "activations", "kv_key", "kv_value",
                          "grads")

_NONE_TOKENS = ("none", "off", "fp")

_SPEC_RE = re.compile(
    r"^(?P<fmt>[^@:+=,\s]+)"
    r"(?:@(?P<block>[^:+]*))?"
    r"(?::(?P<mode>[^+]*))?"
    r"(?:\+(?P<flag>.*))?$")


# =============================================================================
# deprecation bookkeeping (warn once per call site)
# =============================================================================
_WARNED: set = set()


def warn_deprecated(key: str, message: str) -> None:
    """Emit ``message`` as a DeprecationWarning once per ``key``."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def reset_deprecation_warnings() -> None:
    """Clear the warn-once registry (test hook)."""
    _WARNED.clear()


# =============================================================================
# QuantSpec
# =============================================================================
@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize one tensor: element format, mode, block, packing.

    ``packed`` is a storage preference: consumers that support bit-packed
    sub-byte codes (the paged KV page pool) honor it; plain ``MXArray``
    codes always stay one byte per element.
    """

    fmt: str = "e4m3"
    mode: str = "ocp"
    block: int = DEFAULT_BLOCK
    packed: bool = True

    def __post_init__(self):
        # normalize the format name through the registry (raises with the
        # valid-name list on an unknown format)
        object.__setattr__(self, "fmt", get_format(self.fmt).name)
        if self.mode not in MODES:
            raise ValueError(
                f"unknown MX conversion mode {self.mode!r}; choose from "
                f"{list(MODES)}")
        if not isinstance(self.block, int) or isinstance(self.block, bool) \
                or self.block < 1:
            raise ValueError(
                f"block must be a positive integer, got {self.block!r}")

    # ------------------------------------------------------------- grammar
    @classmethod
    def parse(cls, text: str) -> Optional["QuantSpec"]:
        """Parse ``fmt[@block][:mode][+packed|+unpacked]``.

        ``"none"`` / ``"off"`` / ``"fp"`` return ``None`` (fp passthrough).
        Omitted fields take the dataclass defaults (block 32, mode "ocp",
        packed).  Raises ValueError with a precise message on bad input.
        """
        if not isinstance(text, str):
            raise TypeError(f"QuantSpec.parse expects a str, "
                            f"got {type(text).__name__}")
        s = text.strip().lower()
        if not s:
            raise ValueError("empty quantization spec; expected "
                             "'fmt[@block][:mode]' or 'none'")
        if s in _NONE_TOKENS:
            return None
        m = _SPEC_RE.match(s)
        if m is None:
            raise ValueError(
                f"malformed quantization spec {text!r}; expected "
                f"'fmt[@block][:mode][+packed|+unpacked]', "
                f"e.g. 'int8@32:ocp'")
        kw: dict = {"fmt": m.group("fmt")}
        blk = m.group("block")
        if blk is not None:
            if not blk.isdigit() or int(blk) < 1:
                raise ValueError(
                    f"bad block {blk!r} in spec {text!r}; block must be a "
                    f"positive integer (e.g. 'e4m3@32')")
            kw["block"] = int(blk)
        mode = m.group("mode")
        if mode is not None:
            if mode not in MODES:
                raise ValueError(
                    f"bad mode {mode!r} in spec {text!r}; choose from "
                    f"{list(MODES)}")
            kw["mode"] = mode
        flag = m.group("flag")
        if flag is not None:
            if flag not in ("packed", "unpacked"):
                raise ValueError(
                    f"bad flag {flag!r} in spec {text!r}; the only flags "
                    f"are '+packed' and '+unpacked'")
            kw["packed"] = flag == "packed"
        return cls(**kw)          # __post_init__ validates fmt

    def __str__(self) -> str:
        s = f"{self.fmt}@{self.block}:{self.mode}"
        if not self.packed:
            s += "+unpacked"
        return s

    # ------------------------------------------------------------- helpers
    @property
    def format(self) -> MXFormat:
        return get_format(self.fmt)

    def storage_nbytes(self, n: int) -> int:
        """Bytes needed to store ``n`` element codes under this spec's
        packing preference (bit-packed for sub-byte formats iff packed)."""
        from repro_torch.core.pack import packed_nbytes
        return packed_nbytes(self.fmt, n) if self.packed else n

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


def as_spec(spec) -> QuantSpec:
    """Coerce a QuantSpec | spec-string into a QuantSpec (no deprecation
    semantics; ``None``/"none" is rejected — use the policy for absence)."""
    if isinstance(spec, QuantSpec):
        return spec
    if isinstance(spec, str):
        out = QuantSpec.parse(spec)
        if out is None:
            raise ValueError("'none' is not a concrete QuantSpec; pass a "
                             "format spec such as 'e4m3@32:ocp'")
        return out
    raise TypeError(f"expected QuantSpec or spec string, "
                    f"got {type(spec).__name__}")


# =============================================================================
# legacy-kwarg resolution (the deprecation shims' engine)
# =============================================================================
def resolve_spec(spec=None, fmt=None, mode=None, block=None, *,
                 default: Optional[QuantSpec] = None,
                 caller: str = "mx") -> QuantSpec:
    """Resolve the argument soup of a legacy-compatible entry point.

    New forms (no warning): ``spec`` is a QuantSpec, a full spec string
    (contains '@', ':' or '+'), or None with no legacy kwargs (-> the
    entry point's ``default``).  Legacy forms (one DeprecationWarning per
    entry point per process): ``fmt=``/``mode=``/``block=`` kwargs, or a
    bare format name
    in the ``spec`` slot (the old positional-``fmt`` call shape); missing
    legacy fields fall back to ``default``'s, preserving each entry
    point's historical defaults.
    """
    base = default if default is not None else QuantSpec()
    legacy = fmt is not None or mode is not None or block is not None
    if isinstance(spec, QuantSpec):
        if legacy:
            raise TypeError(
                f"{caller}: pass either a QuantSpec or the deprecated "
                f"fmt=/mode=/block= kwargs, not both")
        return spec
    if isinstance(spec, str):
        if any(c in spec for c in "@:+"):
            if legacy:
                raise TypeError(
                    f"{caller}: got both a spec string {spec!r} and "
                    f"deprecated fmt=/mode=/block= kwargs")
            return as_spec(spec)
        # bare format name: the old positional-fmt call shape
        if fmt is not None:
            raise TypeError(f"{caller}: format given twice "
                            f"({spec!r} and fmt={fmt!r})")
        fmt, legacy = spec, True
    elif spec is not None:
        raise TypeError(f"{caller}: spec must be a QuantSpec, a spec "
                        f"string or None, got {type(spec).__name__}")
    if not legacy:
        return base
    warn_deprecated(
        f"{caller}:kwargs",
        f"{caller}: the fmt=/mode=/block= keyword form is deprecated; "
        f"pass a QuantSpec (e.g. QuantSpec.parse("
        f"'{fmt or base.fmt}@{block or base.block}:{mode or base.mode}'))")
    return QuantSpec(fmt=fmt if fmt is not None else base.fmt,
                     mode=mode if mode is not None else base.mode,
                     block=block if block is not None else base.block,
                     packed=base.packed)


def resolve_kv_specs(spec=None, key_spec=None, value_spec=None, fmt=None,
                     mode=None, block=None, *,
                     default: Optional[QuantSpec] = None,
                     caller: str = "mx") -> Tuple[QuantSpec, QuantSpec]:
    """Resolve the (key, value) spec pair of a KV-cache consumer.

    New forms: ``key_spec`` + ``value_spec`` (both required when either is
    given), or the uniform ``spec``.  Legacy ``fmt=``/``mode=`` kwargs set
    both roles to the same spec (one DeprecationWarning per caller).
    """
    base = default if default is not None else QuantSpec()
    legacy = fmt is not None or mode is not None or block is not None
    if legacy:
        if spec is not None or key_spec is not None \
                or value_spec is not None:
            raise TypeError(
                f"{caller}: pass either specs or the deprecated "
                f"fmt=/mode= kwargs, not both")
        s = resolve_spec(None, fmt, mode, block, default=base,
                         caller=caller)
        return s, s
    if spec is not None:
        if key_spec is not None or value_spec is not None:
            raise TypeError(f"{caller}: pass spec= (uniform) or "
                            f"key_spec=/value_spec=, not both")
        s = as_spec(spec)
        return s, s
    if (key_spec is None) != (value_spec is None):
        raise TypeError(f"{caller}: key_spec and value_spec must be "
                        f"given together")
    if key_spec is None:
        return base, base
    return as_spec(key_spec), as_spec(value_spec)


# =============================================================================
# QuantPolicy
# =============================================================================
def _coerce_role(name: str, value) -> Optional[QuantSpec]:
    if value is None:
        return None
    if isinstance(value, str):
        return QuantSpec.parse(value)
    if isinstance(value, QuantSpec):
        return value
    raise TypeError(f"policy role {name!r} must be a QuantSpec, a spec "
                    f"string or None, got {type(value).__name__}")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-tensor-role quantization policy (role -> optional QuantSpec).

    ``None`` for a role means fp passthrough.  ``kv_key`` and ``kv_value``
    must be set together (the KV cache layout is either quantized or
    dense); they may carry *different* specs — mixed-format KV serving.
    """

    weights: Optional[QuantSpec] = None
    activations: Optional[QuantSpec] = None
    kv_key: Optional[QuantSpec] = None
    kv_value: Optional[QuantSpec] = None
    grads: Optional[QuantSpec] = None

    def __post_init__(self):
        for role in ROLES:
            object.__setattr__(self, role,
                               _coerce_role(role, getattr(self, role)))
        if (self.kv_key is None) != (self.kv_value is None):
            raise ValueError(
                "kv_key and kv_value must be set together (use the same "
                "spec for a uniform cache, or 'kv=<spec>' in the policy "
                "grammar)")

    # ------------------------------------------------------------- grammar
    @classmethod
    def parse(cls, text: str) -> "QuantPolicy":
        """Parse ``role=spec[,role=spec...]``; ``kv=`` sets both KV roles;
        empty / ``"none"`` is the all-passthrough policy."""
        if not isinstance(text, str):
            raise TypeError(f"QuantPolicy.parse expects a str, "
                            f"got {type(text).__name__}")
        s = text.strip().lower()
        if not s or s in _NONE_TOKENS:
            return cls()
        kw: dict = {}

        def put(role, sp):
            if role in kw:
                raise ValueError(f"role {role!r} given twice in "
                                 f"policy {text!r}")
            kw[role] = sp

        for item in s.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"malformed policy entry {item!r} in {text!r}; "
                    f"expected 'role=spec' with role in "
                    f"{list(ROLES)} (or 'kv')")
            role, _, spec_s = item.partition("=")
            role = role.strip()
            sp = QuantSpec.parse(spec_s.strip())
            if role == "kv":
                put("kv_key", sp)
                put("kv_value", sp)
            elif role in ROLES:
                put(role, sp)
            else:
                raise ValueError(
                    f"unknown tensor role {role!r} in policy {text!r}; "
                    f"choose from {list(ROLES)} (or 'kv' for both KV "
                    f"roles)")
        return cls(**kw)

    def __str__(self) -> str:
        items = [f"{r}={getattr(self, r)}" for r in ROLES
                 if getattr(self, r) is not None]
        return ",".join(items) if items else "none"

    # ------------------------------------------------------------ accessors
    def role(self, name: str) -> Optional[QuantSpec]:
        if name not in ROLES:
            raise ValueError(f"unknown tensor role {name!r}; choose from "
                             f"{list(ROLES)}")
        return getattr(self, name)

    def replace(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)

    # ----------------------------------------------------------------- JSON
    def to_json_dict(self) -> Dict[str, str]:
        """Role -> spec-string mapping of the set roles (the JSON form)."""
        return {r: str(getattr(self, r)) for r in ROLES
                if getattr(self, r) is not None}

    @classmethod
    def from_json_dict(cls, d: Mapping, *,
                       where: str = "policy") -> "QuantPolicy":
        """Build a policy from a ``{role: spec-string}`` mapping, raising
        precise errors that name ``where`` plus the offending role/spec
        (mirrors ``QuantSpec.parse`` error style)."""
        if not isinstance(d, Mapping):
            raise ValueError(f"{where}: expected an object mapping roles "
                             f"to spec strings, got "
                             f"{type(d).__name__}")
        kw: dict = {}
        for role, spec_s in d.items():
            if role not in ROLES:
                raise ValueError(
                    f"{where}: unknown tensor role {role!r}; choose from "
                    f"{list(ROLES)}")
            if not isinstance(spec_s, str):
                raise ValueError(
                    f"{where}: role {role!r} must map to a spec string, "
                    f"got {type(spec_s).__name__}")
            try:
                kw[role] = QuantSpec.parse(spec_s)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"{where}: role {role!r}: bad spec {spec_s!r}: "
                    f"{e}") from e
        try:
            return cls(**kw)
        except ValueError as e:       # kv_key/kv_value pairing violation
            raise ValueError(f"{where}: {e}") from e

    # ------------------------------------------- legacy MXPolicy read shims
    @property
    def kv_cache(self) -> bool:
        """Legacy read shim: is the KV cache quantized?"""
        return self.kv_key is not None

    @property
    def kv_fmt(self) -> Optional[str]:
        """Legacy read shim: the key-role element format name."""
        return self.kv_key.fmt if self.kv_key is not None else None


# =============================================================================
# PolicyTable — per-layer QuantPolicy (role + layer -> spec)
# =============================================================================
POLICY_TABLE_SCHEMA = "policy_table/v1"


@dataclasses.dataclass(frozen=True)
class PolicyTable:
    """A per-layer quantization policy: ``default`` applies to every layer
    not named in ``overrides`` (a sorted ``(layer, QuantPolicy)`` tuple).

    Layers are indexed absolutely (leading dense layers first, then the
    scanned stack, matching ``ModelConfig`` layer order).  The table is
    frozen and hashable, so — like ``QuantSpec``/``QuantPolicy`` — it can
    key caches and ride through config dataclasses.

    An all-layers-identical table carries no information beyond its
    default; ``collapse()`` returns the plain ``QuantPolicy`` in that case
    so consumers keep the uniform (scanned, bit-identical) code path.
    """

    default: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)
    overrides: Tuple[Tuple[int, QuantPolicy], ...] = ()

    def __post_init__(self):
        if isinstance(self.default, str):
            object.__setattr__(self, "default",
                               QuantPolicy.parse(self.default))
        if not isinstance(self.default, QuantPolicy):
            raise TypeError(
                f"PolicyTable default must be a QuantPolicy or policy "
                f"string, got {type(self.default).__name__}")
        ov = self.overrides
        if isinstance(ov, Mapping):
            ov = tuple(sorted(ov.items()))
        items = []
        seen = set()
        for entry in ov:
            try:
                layer, pol = entry
            except (TypeError, ValueError):
                raise TypeError(
                    f"PolicyTable overrides entries must be (layer, "
                    f"policy) pairs, got {entry!r}") from None
            if not isinstance(layer, int) or isinstance(layer, bool) \
                    or layer < 0:
                raise ValueError(
                    f"PolicyTable layer index must be a non-negative "
                    f"int, got {layer!r}")
            if layer in seen:
                raise ValueError(f"layer {layer} given twice in "
                                 f"PolicyTable overrides")
            seen.add(layer)
            if isinstance(pol, str):
                pol = QuantPolicy.parse(pol)
            if not isinstance(pol, QuantPolicy):
                raise TypeError(
                    f"PolicyTable layer {layer} policy must be a "
                    f"QuantPolicy or policy string, got "
                    f"{type(pol).__name__}")
            items.append((layer, pol))
        object.__setattr__(self, "overrides", tuple(sorted(items)))

    # ----------------------------------------------------------- accessors
    def layer(self, i: int) -> QuantPolicy:
        """The effective policy of absolute layer ``i``."""
        for layer, pol in self.overrides:
            if layer == i:
                return pol
        return self.default

    def spec(self, role: str, layer: int) -> Optional[QuantSpec]:
        """Resolve role + layer -> optional QuantSpec."""
        return self.layer(layer).role(role)

    @property
    def is_uniform(self) -> bool:
        return all(pol == self.default for _, pol in self.overrides)

    def collapse(self) -> Union[QuantPolicy, "PolicyTable"]:
        """The plain ``QuantPolicy`` when every layer agrees, else self."""
        return self.default if self.is_uniform else self

    def replace(self, **kw) -> "PolicyTable":
        return dataclasses.replace(self, **kw)

    def __str__(self) -> str:
        ov = ",".join(f"{i}:[{p}]" for i, p in self.overrides)
        return f"table(default=[{self.default}]" + \
            (f",{ov})" if ov else ")")

    # ----------------------------------------------------------------- JSON
    def to_json_dict(self) -> dict:
        return {
            "schema": POLICY_TABLE_SCHEMA,
            "default": self.default.to_json_dict(),
            "layers": {str(i): p.to_json_dict()
                       for i, p in self.overrides},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), indent=2) + "\n"

    @classmethod
    def from_json_dict(cls, doc) -> "PolicyTable":
        """Parse the ``policy_table/v1`` JSON document form.  Errors are
        precise: they name the offending layer, role, and spec string."""
        if not isinstance(doc, Mapping):
            raise ValueError(
                f"policy table: expected a JSON object, got "
                f"{type(doc).__name__}")
        unknown = sorted(set(doc) - {"schema", "default", "layers"})
        if unknown:
            raise ValueError(
                f"policy table: unknown field(s) {unknown}; expected "
                f"'schema', 'default', 'layers'")
        schema = doc.get("schema")
        if schema != POLICY_TABLE_SCHEMA:
            raise ValueError(
                f"policy table: schema {schema!r} is not "
                f"{POLICY_TABLE_SCHEMA!r}")
        default = QuantPolicy.from_json_dict(doc.get("default", {}),
                                             where="policy table default")
        layers = doc.get("layers", {})
        if not isinstance(layers, Mapping):
            raise ValueError(
                f"policy table: 'layers' must be an object mapping layer "
                f"indices to policies, got {type(layers).__name__}")
        overrides = []
        for key, pol_d in layers.items():
            try:
                layer = int(key)
                if layer < 0:
                    raise ValueError
            except (TypeError, ValueError):
                raise ValueError(
                    f"policy table: bad layer index {key!r}; keys must be "
                    f"non-negative integers") from None
            pol = QuantPolicy.from_json_dict(
                pol_d, where=f"policy table layer {layer}")
            overrides.append((layer, pol))
        return cls(default=default, overrides=tuple(overrides))

    @classmethod
    def from_json(cls, text: str) -> "PolicyTable":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"policy table: invalid JSON: {e}") from e
        return cls.from_json_dict(doc)


def mx_policy(fmt: str = "e4m3", mode: str = "ocp",
              block: int = DEFAULT_BLOCK, weights: bool = False,
              kv_cache: bool = False, grads: bool = False,
              kv_fmt: str = "int8",
              grad_fmt: str = "e4m3") -> QuantPolicy:
    """Deprecation shim for the pre-spec ``MXPolicy`` dataclass: maps the
    old where-booleans + how-strings onto a ``QuantPolicy`` (one
    DeprecationWarning per process)."""
    warn_deprecated(
        "MXPolicy",
        "MXPolicy is deprecated; build a QuantPolicy instead, e.g. "
        "QuantPolicy.parse('kv=int8@32:ocp,weights=e4m3@32:ocp')")
    kv = QuantSpec(kv_fmt, mode, block) if kv_cache else None
    return QuantPolicy(
        weights=QuantSpec(fmt, mode, block) if weights else None,
        kv_key=kv, kv_value=kv,
        grads=QuantSpec(grad_fmt, mode, block) if grads else None)
