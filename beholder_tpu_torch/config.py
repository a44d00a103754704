"""Configuration loading and service discovery.

The port's own copy of the reference's ``config.py``: the triton-core
contracts observable at the reference's call sites:

- ``Config('events')`` loads a config object exposing ``keys.*`` secrets and
  ``instance.*`` settings (index.js:24-25,60,97-115).
- ``dyn('rabbitmq')`` resolves a service name to an address
  (index.js:16,43).
- The single env flag ``NO_TRELLO`` disables Trello side effects
  (index.js:70).

The on-disk format is YAML. PyYAML is imported only when a file is
loaded; where it is not installed, a file whose text is JSON (a subset of
YAML) still loads through :mod:`json`, and any other file raises an
``ImportError`` that names PyYAML.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Iterable, Mapping


class ConfigNode:
    """Read-only attribute + item access over a nested mapping.

    ``node.keys.trello.key`` style access mirrors the JS object access in the
    reference (note: deliberately NOT a ``Mapping`` subclass so that the data
    key ``keys`` is reachable as an attribute). Missing keys raise
    ``KeyError``/``AttributeError``; use ``.get(path, default)`` for optional
    settings (the reference guards optional blocks with truthiness checks,
    index.js:97,110).
    """

    __slots__ = ("_data",)

    def __init__(self, data: Mapping[str, Any] | None):
        object.__setattr__(self, "_data", dict(data or {}))

    def __getitem__(self, key: str) -> Any:
        value = self._data[key]
        return ConfigNode(value) if isinstance(value, Mapping) else value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any):
        raise AttributeError("ConfigNode is read-only")

    def get(self, path: str, default: Any = None) -> Any:
        """Dotted-path lookup: ``config.get('instance.telegram.enabled')``."""
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigNode) and part in node:
                node = node[part]
            else:
                return default
        return node

    def to_dict(self) -> dict[str, Any]:
        return dict(self._data)

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


class Config(ConfigNode):
    """Top-level config for a named service (``Config('events')``)."""

    @classmethod
    def load(
        cls,
        name: str,
        search_paths: Iterable[str | Path] | None = None,
    ) -> "Config":
        """Load ``<name>.yaml`` from the first matching location.

        Order: ``$BEHOLDER_CONFIG`` (explicit file), then ``./config/``,
        ``~/.triton/``, ``/etc/triton/`` (or the caller's ``search_paths``).
        """
        explicit = os.environ.get("BEHOLDER_CONFIG")
        candidates: list[Path] = []
        if explicit:
            # an explicit override must fail fast, never fall through to
            # implicit locations with possibly-stale credentials
            if not Path(explicit).is_file():
                raise FileNotFoundError(
                    f"$BEHOLDER_CONFIG points to {explicit!r}, which does not exist"
                )
            candidates.append(Path(explicit))
        roots = (
            [Path(p) for p in search_paths]
            if search_paths is not None
            else [Path("config"), Path.home() / ".triton", Path("/etc/triton")]
        )
        candidates.extend(root / f"{name}.yaml" for root in roots)

        for path in candidates:
            if path.is_file():
                with open(path, "r", encoding="utf-8") as fh:
                    data = _parse(fh.read(), path) or {}
                return cls(data)
        raise FileNotFoundError(
            f"no config file for service {name!r}; looked in: "
            + ", ".join(str(c) for c in candidates)
        )


def _parse(text: str, path: Path) -> Any:
    """YAML through PyYAML; without PyYAML, JSON text through ``json``."""
    try:
        import yaml
    except ImportError:
        import json

        try:
            return json.loads(text)
        except ValueError:
            raise ImportError(
                f"{path} is not JSON, and reading YAML needs PyYAML, "
                "which is not installed"
            ) from None
    return yaml.safe_load(text)


#: Default address book for ``dyn()``. The reference resolves only
#: ``rabbitmq`` (index.js:43); the rest cover the stack's other services so
#: the contract is complete.
_DEFAULT_PORTS = {
    "rabbitmq": ("amqp", 5672),
    "postgres": ("postgres", 5432),
    "emby": ("http", 8096),
}


def dyn(service: str) -> str:
    """Resolve a service name to a connection URL.

    Resolution order (reconstruction of triton-core/dynamics):

    1. ``$<SERVICE>_URL`` — full URL override.
    2. ``$<SERVICE>_HOST`` (+ optional ``$<SERVICE>_PORT``) — host override.
    3. ``$DNS_PREFIX`` — cluster-style ``<scheme>://<service>.<prefix>:<port>``.
    4. localhost with the service's default port.
    """
    env = service.upper().replace("-", "_")
    url = os.environ.get(f"{env}_URL")
    if url:
        return url

    scheme, port = _DEFAULT_PORTS.get(service, ("http", 80))
    port = int(os.environ.get(f"{env}_PORT", port))

    host = os.environ.get(f"{env}_HOST")
    if not host:
        prefix = os.environ.get("DNS_PREFIX")
        host = f"{service}.{prefix}" if prefix else "127.0.0.1"
    return f"{scheme}://{host}:{port}"


def no_trello() -> bool:
    """The reference's single env toggle (index.js:70) — any non-empty value."""
    return bool(os.environ.get("NO_TRELLO"))
