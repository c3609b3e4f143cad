"""Model definitions: spec builder, trunk layers, Detect header, Model."""

from .builder import HeaderSpec, LayerSpec, NetworkSpec, normalize_legacy_cfg, parse_model_cfg  # noqa: F401
