"""The wire ``TaskConfig`` and the port's task-config dataclasses.

``taskmgr/codecs.py`` decodes task JSON into dataclasses that carry every
field name and zero value of the protobuf ``TaskConfig``
(``proto/taskservice.proto``), so one walk over the dataclass fields maps
the two forms field for field: nested messages are always set (as the JAX
package's ``json2taskconfig`` sets each one through its constructor),
repeated fields are extended in order, and the ``FileTransferType`` fields
carry their wire numbers, checked against the enum's names. This is a wire
module: it imports protobuf, so the codecs stay free of it.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

from olearning_sim_tpu_torch.proto import taskservice_pb2 as pb
from olearning_sim_tpu_torch.taskmgr import codecs


@functools.lru_cache(maxsize=None)
def _fields(cls):
    """``(name, nested dataclass or None, repeated)`` of a dataclass's fields."""
    hints = typing.get_type_hints(cls, vars(codecs))
    out = []
    for f in dataclasses.fields(cls):
        hint = hints[f.name]
        repeated = typing.get_origin(hint) in (list, typing.List)
        inner = typing.get_args(hint)[0] if repeated else hint
        out.append((f.name, inner if dataclasses.is_dataclass(inner) else None, repeated))
    return tuple(out)


def _check_enums(msg) -> None:
    """A ``FileTransferType`` field's number names the same type in the enum
    and in the codecs' table; a number outside either raises."""
    for field in msg.DESCRIPTOR.fields:
        if field.enum_type is not None and field.enum_type.name == "FileTransferType":
            number = getattr(msg, field.name)
            value = field.enum_type.values_by_number.get(number)
            if value is None or number >= len(codecs.TRANSFER_TYPES) or \
                    value.name != codecs._transfer_name(number):
                raise ValueError(f"{field.name}: FileTransferType {number} is not one of "
                                 f"the codecs' transfer types {codecs.TRANSFER_TYPES}")


def _fill(msg, obj) -> None:
    for name, nested, repeated in _fields(type(obj)):
        value = getattr(obj, name)
        if nested is None and repeated:
            getattr(msg, name).extend(value)
        elif nested is None:
            setattr(msg, name, value)
        elif repeated:
            for item in value:
                _fill(getattr(msg, name).add(), item)
        else:
            sub = getattr(msg, name)
            sub.SetInParent()
            _fill(sub, value)
    _check_enums(msg)


def _read(cls, msg):
    _check_enums(msg)
    kwargs = {}
    for name, nested, repeated in _fields(cls):
        value = getattr(msg, name)
        if nested is None:
            kwargs[name] = list(value) if repeated else value
        elif repeated:
            kwargs[name] = [_read(nested, item) for item in value]
        else:
            kwargs[name] = _read(nested, value)
    return cls(**kwargs)


def taskconfig_to_proto(tc: codecs.TaskConfig) -> pb.TaskConfig:
    """The wire message of a :class:`~olearning_sim_tpu_torch.taskmgr.codecs.TaskConfig`."""
    msg = pb.TaskConfig()
    _fill(msg, tc)
    return msg


def taskconfig_from_proto(msg) -> codecs.TaskConfig:
    """The dataclass of a wire ``TaskConfig`` (the port's message, or any
    message with the same field names, such as the JAX package's)."""
    return _read(codecs.TaskConfig, msg)
