"""Minimal SOFA (SimpleFreeFieldHRIR) reader built on h5py.

Covers exactly what the HeSuVi converter needs from a SOFA container:
Data.IR / Data.SamplingRate / Data.Delay, the listener's orthonormal frame,
source directions (spherical-degrees or cartesian-metres), and which
receiver index is the left vs right ear. The reference tool
(tools/ss2-to-hesuvi/convert.py:287-333) reads the same
fields through the sofar library; only the field semantics are shared —
this reader speaks HDF5 directly.

Port of airwave_tpu/tools/sofa.py, the same host code: the port keeps its
own copy and imports no module of the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Tuple

import numpy as np

EPSILON = 1e-9


class ConversionError(RuntimeError):
    """A SOFA container that this converter cannot faithfully translate."""


@dataclasses.dataclass
class SofaHRIR:
    source_path: str
    source_hash: str
    listener_short_name: str
    database_name: str
    license_name: str
    sample_rate: int
    impulse_responses: np.ndarray  # [M, 2, N] float64
    delays: np.ndarray             # [M, 2] float64 (samples)
    source_vectors: np.ndarray     # [M, 3] unit vectors in listener frame
    source_azimuths: np.ndarray    # [M] degrees, +left
    source_elevations: np.ndarray  # [M] degrees
    left_receiver: int
    right_receiver: int


def sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _attr(obj, name: str, default: str = "") -> str:
    value = obj.attrs.get(name, default)
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, np.ndarray):
        value = value.tobytes().decode("utf-8", "replace") if value.dtype.kind == "S" \
            else str(value)
    return str(value)


def _coord_matrix(value, name: str) -> np.ndarray:
    """Coerce an HDF5 position variable to [rows, 3] float64, accepting the
    squeezed / transposed layouts different writers emit."""
    array = np.asarray(value, np.float64).squeeze()
    if array.ndim == 1 and array.size == 3:
        return array.reshape(1, 3)
    if array.ndim == 2:
        if array.shape[1] == 3:
            return array
        if array.shape[0] == 3:
            return array.T
    raise ConversionError(f"cannot interpret {name} with shape {array.shape}")


def _single_position(value, name: str) -> np.ndarray:
    rows = _coord_matrix(value, name)
    if rows.shape[0] > 1 and np.ptp(rows, axis=0).max() > EPSILON:
        raise ConversionError(f"{name} varies across measurements")
    return rows[0]


def _unit(vector: np.ndarray, what: str) -> np.ndarray:
    norm = np.linalg.norm(vector)
    if norm <= EPSILON:
        raise ConversionError(f"{what} has no usable direction (norm ~ 0)")
    return vector / norm


def _spherical_to_cartesian(positions: np.ndarray) -> np.ndarray:
    az = np.deg2rad(positions[:, 0])
    el = np.deg2rad(positions[:, 1])
    r = positions[:, 2]
    return np.stack(
        [r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)],
        axis=1,
    )


def _dataset(f, name: str):
    """A required SOFA variable, as a ConversionError (not KeyError) when
    absent so batch conversion reports the file and moves on."""
    if name not in f:
        raise ConversionError(f"missing required SOFA variable {name}")
    return f[name]


def _orientation_vector(raw: np.ndarray, kind: str, name: str) -> np.ndarray:
    """A ListenerView/ListenerUp row as a cartesian direction. Spherical
    orientations ([azimuth, elevation, radius] in degrees) are legal SOFA
    (AES69 §4.4.2: the Type attribute on ListenerView governs both) and
    must be converted, not reinterpreted component-wise; a zero radius
    still encodes a direction, so it is normalized to 1 before the
    conversion."""
    if kind == "cartesian":
        return raw
    if kind == "spherical":
        row = np.array(raw, np.float64)
        if abs(row[2]) <= EPSILON:
            row[2] = 1.0
        return _spherical_to_cartesian(row.reshape(1, 3))[0]
    raise ConversionError(f"unhandled {name} type {kind!r}")


def _listener_frame(f) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Gram-Schmidt the listener's (view, up) into an orthonormal
    (position, forward, left, up) frame. ListenerView/ListenerUp are
    optional in AES69 and default to +x forward / +z up."""
    lp_var = _dataset(f, "ListenerPosition")
    if _attr(lp_var, "Type", "cartesian").lower() != "cartesian":
        raise ConversionError("only cartesian ListenerPosition is handled")
    position = _single_position(lp_var[()], "ListenerPosition")
    if "ListenerView" in f:
        lv_var = f["ListenerView"]
        # Per AES69 the coordinate Type/Units attached to ListenerView
        # apply to ListenerUp as well (ListenerUp carries no attributes).
        kind = _attr(lv_var, "Type", "cartesian").lower()
        raw_view = _single_position(lv_var[()], "ListenerView")
        view = _orientation_vector(raw_view, kind, "ListenerView")
        if "ListenerUp" in f:
            raw_up = _single_position(f["ListenerUp"][()], "ListenerUp")
            raw_up = _orientation_vector(raw_up, kind, "ListenerUp")
        else:
            raw_up = np.array([0.0, 0.0, 1.0])
    else:
        view = np.array([1.0, 0.0, 0.0])
        raw_up = np.array([0.0, 0.0, 1.0])
    forward = _unit(view, "ListenerView")
    up = _unit(
        raw_up - np.dot(raw_up, forward) * forward,
        "ListenerUp (after removing the ListenerView component)",
    )
    left = _unit(np.cross(up, forward), "listener left axis")
    return position, forward, left, up


def _require_units(var, allowed: Tuple[str, ...], name: str) -> None:
    units = _attr(var, "Units").lower()
    if not any(token in units for token in allowed):
        raise ConversionError(
            f"{name} units {units!r} are not among {'/'.join(allowed)}"
        )


def _source_geometry(f, frame_axes):
    """Source directions as unit vectors in the listener frame, plus the
    derived azimuth (+ = listener-left) and elevation angles in degrees."""
    position, forward, left, up = frame_axes
    var = _dataset(f, "SourcePosition")
    positions = _coord_matrix(var[()], "SourcePosition")
    kind = _attr(var, "Type").lower()
    if kind == "spherical":
        _require_units(var, ("degree",), "spherical SourcePosition")
        world = _spherical_to_cartesian(positions)
    elif kind == "cartesian":
        _require_units(var, ("metre", "meter"), "cartesian SourcePosition")
        world = positions
    else:
        raise ConversionError(f"unhandled SourcePosition type {kind!r}")

    offsets = world - position
    distances = np.linalg.norm(offsets, axis=1)
    if np.any(distances <= EPSILON):
        raise ConversionError(
            "a source sits on top of the listener; its direction is undefined"
        )
    rays = offsets / distances[:, None]
    # Project onto the listener frame: columns = (forward, left, up).
    frame = np.stack([forward, left, up], axis=1)
    directions = rays @ frame
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    azimuths = np.degrees(np.arctan2(directions[:, 1], directions[:, 0]))
    elevations = np.degrees(np.arcsin(np.clip(directions[:, 2], -1.0, 1.0)))
    return directions, azimuths, elevations


def _receivers(f, frame_axes) -> Tuple[int, int]:
    """Identify (left_ear_index, right_ear_index) from receiver geometry:
    the ear with positive lateral offset along the listener's left axis is
    the left ear."""
    var = _dataset(f, "ReceiverPosition")
    if _attr(var, "Type").lower() != "cartesian":
        raise ConversionError("only cartesian ReceiverPosition is handled")
    _require_units(var, ("metre", "meter"), "ReceiverPosition")
    positions = _coord_matrix(var[()], "ReceiverPosition")
    if positions.shape[0] != 2:
        raise ConversionError(
            f"need exactly 2 receivers for a binaural set, found "
            f"{positions.shape[0]}"
        )
    listener_position, _, left_axis, _ = frame_axes
    leftness = (positions - listener_position) @ left_axis
    if not (leftness.max() > EPSILON and leftness.min() < -EPSILON):
        raise ConversionError(
            "receiver geometry is ambiguous: could not place one ear on each "
            "side of the listener"
        )
    return int(np.argmax(leftness)), int(np.argmin(leftness))


def _expand_delays(raw, measurements: int) -> np.ndarray:
    """Broadcast Data.Delay's scalar / [2] / [M, 2] layouts to [M, 2]."""
    array = np.asarray(raw, np.float64).squeeze()
    if array.ndim == 0:
        array = np.full((measurements, 2), float(array))
    elif array.shape == (2,):
        array = np.tile(array, (measurements, 1))
    elif array.shape != (measurements, 2):
        raise ConversionError(f"cannot broadcast Data.Delay {array.shape}")
    if not np.all(np.isfinite(array)) or np.any(array < 0):
        raise ConversionError("Data.Delay has negative or non-finite entries")
    return array


def read_sofa_hrir(path: str) -> SofaHRIR:
    import h5py

    try:
        f = h5py.File(path, "r")
    except OSError as err:
        raise ConversionError(f"not a readable SOFA/HDF5 file: {err}")
    with f:
        conventions = _attr(f, "SOFAConventions")
        if conventions != "SimpleFreeFieldHRIR":
            raise ConversionError(
                f"convention {conventions!r} is not SimpleFreeFieldHRIR"
            )
        data_type = _attr(f, "DataType")
        if data_type != "FIR":
            raise ConversionError(f"data type {data_type!r} is not FIR")

        impulses = np.asarray(_dataset(f, "Data.IR")[()], np.float64)
        if impulses.ndim != 3 or impulses.shape[1] != 2 or impulses.shape[2] == 0:
            raise ConversionError(
                f"Data.IR shape {impulses.shape} is not [M, 2, N>0]"
            )
        if not np.all(np.isfinite(impulses)):
            raise ConversionError("Data.IR has NaN/inf samples")

        rates = np.asarray(_dataset(f, "Data.SamplingRate")[()],
                           np.float64).reshape(-1)
        if rates.size != 1 or not np.isfinite(rates[0]) or rates[0] <= 0:
            raise ConversionError("Data.SamplingRate is not a single positive value")
        rate = int(round(float(rates[0])))
        if not math.isclose(float(rates[0]), rate, abs_tol=1e-6):
            raise ConversionError(
                f"sample rate {rates[0]} is not an integer; WAV output needs one"
            )

        # The listener frame is validated/built once and shared by the
        # geometry and receiver passes.
        frame_axes = _listener_frame(f)
        vectors, azimuths, elevations = _source_geometry(f, frame_axes)
        if vectors.shape[0] != impulses.shape[0]:
            raise ConversionError(
                f"{vectors.shape[0]} source positions vs "
                f"{impulses.shape[0]} IR measurements"
            )
        left, right = _receivers(f, frame_axes)
        delays = _expand_delays(
            f["Data.Delay"][()] if "Data.Delay" in f else 0.0,
            impulses.shape[0],
        )

        return SofaHRIR(
            source_path=path,
            source_hash=sha256_file(path),
            listener_short_name=_attr(f, "ListenerShortName"),
            database_name=_attr(f, "DatabaseName"),
            license_name=_attr(f, "License"),
            sample_rate=rate,
            impulse_responses=impulses,
            delays=delays,
            source_vectors=vectors,
            source_azimuths=azimuths,
            source_elevations=elevations,
            left_receiver=left,
            right_receiver=right,
        )
