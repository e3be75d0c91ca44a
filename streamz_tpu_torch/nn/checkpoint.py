"""``model.npz`` checkpoint reader/writer, schema-compatible with the reference
and with the JAX package (``streamz_tpu/nn/checkpoint.py``): a model saved by
either package loads in the other.

Writer schema (``streamz-rs/src/lib.rs:1081-1130``):

- ``w1``, ``b1``, ``w2``, ``b2``: f32 weight arrays.
- ``sample_rate``, ``bits``, ``num_speakers``: i64 arrays of length 1.
- ``w3_{i+1}`` (f32 column of length h2) and ``b3_{i+1}`` (f32 length 1) for
  each *live* speaker column — the capacity padding never leaks to disk.
- optional stego layer ``w4_{i+1}``/``b4_{i+1}`` per output bit.
- ``speaker_{i}_files``: u8 bytes of newline-joined training paths.
- ``speaker_embeddings`` [S x h2] + ``speaker_mean_sims`` + ``speaker_std_sims``
  when embeddings are present.

Reader tolerances (``src/lib.rs:1132-1281``): a legacy monolithic ``w3``/``b3``
pair when no ``w3_{i}`` columns exist, the speaker count from the
``num_speakers`` scalar when present, every other entry optional, and keys
with or without a trailing ``.npy``.
"""

from __future__ import annotations

import hashlib
import io
import os
import tempfile
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from streamz_tpu_torch.nn.convert import params_from_numpy, params_to_numpy
from streamz_tpu_torch.nn.model import SpeakerMLP, SpeakerNet, round_capacity


def save(net: SpeakerNet, path: str) -> None:
    """Serialize a :class:`SpeakerNet` to the reference npz schema,
    atomically (temp file + fsync + rename in the target directory)."""
    p = params_to_numpy(net.params)
    arrays: Dict[str, np.ndarray] = {
        "w1": p["w1"], "b1": p["b1"], "w2": p["w2"], "b2": p["b2"],
        "sample_rate": np.array([net.sample_rate], np.int64),
        "bits": np.array([net.bits], np.int64),
        "num_speakers": np.array([net.num_speakers], np.int64),
    }
    for idx in range(net.num_speakers):
        arrays[f"w3_{idx + 1}"] = p["w3"][:, idx].copy()
        arrays[f"b3_{idx + 1}"] = np.array([p["b3"][idx]], np.float32)
    if net.w4 is not None and net.b4 is not None:
        for idx in range(net.b4.shape[0]):
            arrays[f"w4_{idx + 1}"] = np.asarray(net.w4[:, idx], np.float32)
            arrays[f"b4_{idx + 1}"] = np.array([net.b4[idx]], np.float32)
    for idx in range(net.num_speakers):
        files = net.file_lists[idx] if idx < len(net.file_lists) else []
        arrays[f"speaker_{idx}_files"] = np.frombuffer(
            "\n".join(files).encode("utf-8"), dtype=np.uint8
        ).copy()
    if net.embeddings:
        dim = len(net.embeddings[0][0])
        embeds = np.zeros((len(net.embeddings), dim), np.float32)
        mean_sims = np.zeros(len(net.embeddings), np.float32)
        std_sims = np.zeros(len(net.embeddings), np.float32)
        for i, (e, m, s) in enumerate(net.embeddings):
            embeds[i] = np.asarray(e, np.float32)
            mean_sims[i] = m
            std_sims[i] = s
        arrays["speaker_embeddings"] = embeds
        arrays["speaker_mean_sims"] = mean_sims
        arrays["speaker_std_sims"] = std_sims
    # Write through a file handle (np.savez(path_str) appends '.npz' to a
    # custom suffix) and rename into place, so a concurrent reader never
    # observes a partially-written npz.
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".model-", suffix=".npz.tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        # mkstemp creates 0600: keep the existing file's mode, else the
        # umask default an open()-based writer would have used.
        try:
            mode = os.stat(path).st_mode & 0o777
        except OSError:
            um = os.umask(0)
            os.umask(um)
            mode = 0o666 & ~um
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# Decompressed-size caps: a hostile "model.npz" must fail with a clean
# ValueError, not exhaust memory (a zip entry can inflate ~1000x, and many
# small entries can sum past any per-entry cap).
_DEFAULT_MAX_ENTRY_BYTES = 4 << 30


def _env_bytes(name: str, default: int) -> int:
    """A byte cap from the environment, read at call time; a malformed
    override raises a ValueError naming the variable."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def _max_entry_bytes() -> int:
    """The per-entry cap (``STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES``)."""
    return _env_bytes("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", _DEFAULT_MAX_ENTRY_BYTES)


def _max_total_bytes(entry_cap: int) -> int:
    """The cap on all entries together (``STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES``,
    default twice the entry cap)."""
    return _env_bytes("STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES", 2 * entry_cap)


def _read_npz_raw(path: str) -> Dict[str, np.ndarray]:
    """Read an npz whose entries may or may not carry a ``.npy`` extension.
    Entries are decoded in memory with ``allow_pickle=False`` and checked
    against per-entry and total decompressed-size caps before allocation.

    Two entries that name one key (``w1`` and ``w1.npy``) raise a
    ValueError before any entry is decoded.  The JAX package lets the last
    one win and has no total cap of its own (PARITY.md)."""
    out: Dict[str, np.ndarray] = {}
    cap = _max_entry_bytes()
    total_cap = _max_total_bytes(cap)
    total = 0
    with zipfile.ZipFile(path, "r") as zf:
        infos = zf.infolist()
        seen: Dict[str, str] = {}
        for info in infos:
            name = info.filename
            key = name[:-4] if name.endswith(".npy") else name
            if key in seen:
                raise ValueError(
                    f"checkpoint entries {seen[key]!r} and {name!r} both name "
                    f"the key {key!r}"
                )
            seen[key] = name
        for info in infos:
            if info.file_size > cap:
                raise ValueError(
                    f"checkpoint entry {info.filename!r} inflates to "
                    f"{info.file_size} bytes (cap {cap}; override via "
                    "STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES)"
                )
            total += info.file_size
            if total > total_cap:
                raise ValueError(
                    f"checkpoint inflates to {total}+ bytes across entries "
                    f"(total cap {total_cap}; override via "
                    "STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES)"
                )
            name = info.filename
            key = name[:-4] if name.endswith(".npy") else name
            with zf.open(name) as f:
                out[key] = np.load(io.BytesIO(f.read()), allow_pickle=False)
    return out


def load(path: str, device=None) -> SpeakerNet:
    """Deserialize ``model.npz`` (src/lib.rs:1132-1281) onto ``device``
    (``cuda`` unless ``'cpu'`` is asked for).

    Raise-or-load contract: a malformed file (truncated, bit-flipped, wrong
    dtypes/shapes, missing core entries) raises BEFORE any state is built,
    so a failed load never partially applies."""
    data = _read_npz_raw(path)
    w1 = np.asarray(data["w1"], np.float32)
    b1 = np.asarray(data["b1"], np.float32)
    w2 = np.asarray(data["w2"], np.float32)
    b2 = np.asarray(data["b2"], np.float32)
    if w1.ndim != 2 or w2.ndim != 2 or b1.ndim != 1 or b2.ndim != 1 or (
        w1.shape[1] != b1.shape[0]
        or w2.shape[0] != w1.shape[1]
        or w2.shape[1] != b2.shape[0]
    ):
        raise ValueError(
            "inconsistent core weight shapes: "
            f"w1{w1.shape} b1{b1.shape} w2{w2.shape} b2{b2.shape}"
        )
    sample_rate = int(np.asarray(data["sample_rate"]).ravel()[0])
    bits = int(np.asarray(data["bits"]).ravel()[0])

    # Per-column w3_{i}/b3_{i} entries, 1-indexed, contiguous from 1.
    columns: List[np.ndarray] = []
    biases: List[float] = []
    idx = 1
    while f"w3_{idx}" in data and f"b3_{idx}" in data:
        columns.append(np.asarray(data[f"w3_{idx}"], np.float32).ravel())
        biases.append(float(np.asarray(data[f"b3_{idx}"]).ravel()[0]))
        idx += 1

    hidden2 = w2.shape[1]
    if columns:
        w3_live = np.stack(columns, axis=1)
        b3_live = np.array(biases, np.float32)
    elif "w3" in data:
        # Legacy monolithic layout (src/lib.rs:1199-1207).
        w3_live = np.asarray(data["w3"], np.float32)
        b3_live = np.asarray(data["b3"], np.float32).ravel()
    else:
        # A 0-speaker checkpoint keeps zero live columns.
        w3_live = np.zeros((hidden2, 0), np.float32)
        b3_live = np.zeros((0,), np.float32)
    if w3_live.ndim != 2 or w3_live.shape[0] != hidden2 or (
        w3_live.shape[1] != b3_live.shape[0]
    ):
        raise ValueError(
            f"inconsistent output layer: w3{w3_live.shape} b3{b3_live.shape} "
            f"for h2={hidden2}"
        )

    # Optional stego layer columns (src/lib.rs:1169-1186, :1209-1226).
    columns4: List[np.ndarray] = []
    biases4: List[float] = []
    idx4 = 1
    while f"w4_{idx4}" in data and f"b4_{idx4}" in data:
        columns4.append(np.asarray(data[f"w4_{idx4}"], np.float32).ravel())
        biases4.append(float(np.asarray(data[f"b4_{idx4}"]).ravel()[0]))
        idx4 += 1
    w4 = np.stack(columns4, axis=1) if columns4 else None
    b4 = np.array(biases4, np.float32) if columns4 else None

    if "num_speakers" in data:
        outputs = int(np.asarray(data["num_speakers"]).ravel()[0])
        # The scalar steers allocation below: bound it (1 M speakers keeps
        # the worst-case padding matrix near 1 GB).
        if not 0 <= outputs <= 1_000_000:
            raise ValueError(
                f"num_speakers={outputs} outside the sane range [0, 1e6]"
            )
    else:
        outputs = w3_live.shape[1]  # src/lib.rs:1227-1233

    file_lists: List[List[str]] = []
    for i in range(outputs):
        key = f"speaker_{i}_files"
        if key in data:
            text = bytes(np.asarray(data[key], np.uint8)).decode("utf-8", "replace")
            file_lists.append(text.splitlines() if text else [])
        else:
            file_lists.append([])

    embeddings: List[Tuple[np.ndarray, float, float]] = []
    if "speaker_embeddings" in data:
        embeds = np.asarray(data["speaker_embeddings"], np.float32)
        n_emb = embeds.shape[0]

        def _sims(key: str) -> np.ndarray:
            # Optional like every other non-core entry: missing values
            # degrade to 0.0 (an uncalibrated speaker for the gate).
            out = np.zeros(n_emb, np.float32)
            if key in data:
                v = np.asarray(data[key], np.float32).ravel()[:n_emb]
                out[: v.size] = v
            return out

        mean_sims = _sims("speaker_mean_sims")
        std_sims = _sims("speaker_std_sims")
        for i in range(n_emb):
            embeddings.append((embeds[i].copy(), float(mean_sims[i]), float(std_sims[i])))

    # Re-pad the live columns to the 128-aligned capacity with the JAX
    # package's content-seeded padding, so both packages load the same
    # parameters bit for bit.
    cap = round_capacity(max(outputs, w3_live.shape[1], 1))
    digest = hashlib.sha256()
    digest.update(np.ascontiguousarray(w3_live).tobytes())
    digest.update(np.ascontiguousarray(b3_live).tobytes())
    seed = int.from_bytes(digest.digest()[:4], "little")
    rng = np.random.default_rng(seed)
    w3_full = rng.uniform(-0.5, 0.5, size=(hidden2, cap)).astype(np.float32)
    b3_full = np.zeros((cap,), np.float32)
    n_live = w3_live.shape[1]
    w3_full[:, :n_live] = w3_live
    b3_full[:n_live] = b3_live

    params = params_from_numpy(
        {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3_full, "b3": b3_full},
        device=device,
    )
    return SpeakerNet(
        mlp=SpeakerMLP(params),
        num_speakers=outputs,
        file_lists=file_lists,
        sample_rate=sample_rate,
        bits=bits,
        embeddings=embeddings,
        w4=w4,
        b4=b4,
    )
