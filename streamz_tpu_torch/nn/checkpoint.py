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

import contextlib
import hashlib
import io
import math
import os
import re
import struct
import tempfile
import zipfile
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from streamz_tpu_torch.nn.convert import params_from_numpy, params_to_numpy
from streamz_tpu_torch.nn.model import SpeakerMLP, SpeakerNet, round_capacity
from streamz_tpu_torch.runtime.profiler import span


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


# The `.npy` form the reader takes without ``np.load``: format 1.0, a
# little-endian or byte-sized number type, C order and an integer shape, in
# the dictionary numpy's and the Rust writer's headers hold, space-padded.
# Every other entry goes through ``np.load`` as it did before.
_NPY_V1 = b"\x93NUMPY\x01\x00"
_DIM = rb"(?:0|[1-9][0-9]*)"
_NPY_HEADER = re.compile(
    rb"\{'descr': '(<f[248]|<[iu][1248]|\|[iu]1)', 'fortran_order': False, "
    rb"'shape': \((|" + _DIM + rb",|" + _DIM + rb"(?:, " + _DIM + rb")+,?)\), \} *\n?")
_NPY_MAX_HEADER = 10000  # numpy's own limit on a header it parses
# A zip local header's signature, flags, name and extra lengths.
_ZIP_LOCAL = struct.Struct("<4s2xH18x2H")
_F32 = np.dtype("<f4")
# A fast entry: the byte offset of its data, its dtype, shape and element count.
_Fast = Tuple[int, np.dtype, Tuple[int, ...], int]


def _npy_header(header: bytes) -> Optional[Tuple[np.dtype, Tuple[int, ...], int]]:
    """(dtype, shape, element count) of a header the strict form accepts,
    None for every other (numpy reads those)."""
    m = _NPY_HEADER.fullmatch(header)
    if m is None:
        return None
    shape = tuple(int(d) for d in m.group(2).replace(b",", b" ").split())
    return np.dtype(m.group(1).decode()), shape, math.prod(shape)


class _Npz:
    """The entries of an npz whose entries may or may not carry a ``.npy``
    extension, read in one pass over the file.

    Two entries that name one key (``w1`` and ``w1.npy``) raise a
    ValueError before any entry is decoded; the JAX package lets the last
    one win.  Each entry is held to the per-entry and total
    decompressed-size caps before it is decoded, so a hostile file fails
    with a ValueError before allocation; the JAX package has no total cap
    of its own (PARITY.md).

    An entry that is stored, whose local header names it as the directory
    does, whose bytes lie inside the file before the next entry and match
    the directory's CRC, and whose ``.npy`` header has the strict form with
    the data its shape needs, is *fast*: a view into the file's bytes,
    copied where it leaves.  Every other entry is *fallback*: the zipfile
    module reads it and ``np.load(..., allow_pickle=False)`` decodes it, as
    every entry was before, with the same refusals (a bit flip, a bad local
    header, a pickle, short data).  The file is read once when it is no
    larger than the total cap, else every entry is fallback."""

    def __init__(self, f, zf: zipfile.ZipFile, cap: int, total_cap: int) -> None:
        infos = zf.infolist()
        seen: Dict[str, str] = {}
        keys = []
        for info in infos:
            name = info.filename
            key = name[:-4] if name.endswith(".npy") else name
            if key in seen:
                raise ValueError(
                    f"checkpoint entries {seen[key]!r} and {name!r} both name "
                    f"the key {key!r}"
                )
            seen[key] = name
            keys.append(key)
        self._zf = zf
        self.buf = b""
        if os.fstat(f.fileno()).st_size <= total_cap:
            f.seek(0)
            self.buf = f.read()
        self._mv = memoryview(self.buf)
        # Where each entry must end: the next local header, or the central
        # directory (zipfile's own bound on an entry, computed alike).
        ends: Dict[int, int] = {}
        end = zf.start_dir
        for info in reversed(sorted(infos, key=lambda i: i.header_offset)):
            ends[id(info)] = end
            end = info.header_offset
        headers: Dict[bytes, object] = {}
        self.fast: Dict[str, _Fast] = {}
        #: key -> ZipInfo of the entries np.load decodes
        self.fallback: Dict[str, zipfile.ZipInfo] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        total = 0
        for key, info in zip(keys, infos):
            if info.file_size > cap:
                self._refuse(
                    f"checkpoint entry {info.filename!r} inflates to "
                    f"{info.file_size} bytes (cap {cap}; override via "
                    "STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES)"
                )
            total += info.file_size
            if total > total_cap:
                self._refuse(
                    f"checkpoint inflates to {total}+ bytes across entries "
                    f"(total cap {total_cap}; override via "
                    "STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES)"
                )
            entry = self._locate(info, ends[id(info)], headers)
            if entry is None:
                self.fallback[key] = info
            else:
                self.fast[key] = entry

    def _refuse(self, message: str) -> None:
        """A cap's ValueError, after the entries before it have been decoded
        (the first of them that fails raises its own error first, as when
        each entry was decoded right after its check)."""
        self.decode()
        raise ValueError(message)

    def _locate(self, info: zipfile.ZipInfo, end: int,
                headers: Dict[bytes, object]) -> Optional[_Fast]:
        """The fast form of one entry, None where it falls back."""
        buf, h, size = self.buf, info.header_offset, info.file_size
        if (info.compress_type != zipfile.ZIP_STORED or info.compress_size != size
                or info.flag_bits & 0x61 or not 0 <= h <= len(buf) - 30):
            return None  # deflated, encrypted (bits 0, 6) or patched (bit 5); or unread
        sig, flags, n, e = _ZIP_LOCAL.unpack_from(buf, h)
        start = h + 30 + n + e
        if (sig != b"PK\x03\x04" or start + size > min(end, len(buf)) or size < 10
                or not buf.startswith(_NPY_V1, start)):
            return None
        name = buf[h + 30:h + 30 + n]
        try:  # as zipfile decodes the local header's name (ASCII reads alike in both)
            name = name.decode("ascii" if name.isascii() else
                               "utf-8" if flags & 0x800 else "cp437")
        except UnicodeDecodeError:
            return None
        if name != info.orig_filename or zlib.crc32(self._mv[start:start + size]) != info.CRC:
            return None
        hlen = buf[start + 8] | buf[start + 9] << 8
        if hlen > _NPY_MAX_HEADER or 10 + hlen > size:
            return None
        header = buf[start + 10:start + 10 + hlen]
        parsed = headers.get(header, False)
        if parsed is False:
            parsed = headers[header] = _npy_header(header)
        if parsed is None:
            return None
        dtype, shape, count = parsed
        if 10 + hlen + count * dtype.itemsize > size:
            return None  # short data: np.load raises
        return start + 10 + hlen, dtype, shape, count

    def decode(self) -> None:
        """np.load each fallback entry, in the directory's order."""
        for key, info in self.fallback.items():
            with self._zf.open(info.filename) as f:
                self.arrays[key] = np.load(io.BytesIO(f.read()), allow_pickle=False)

    def __contains__(self, key: str) -> bool:
        return key in self.fast or key in self.arrays

    def __getitem__(self, key: str) -> np.ndarray:
        if key in self.arrays:
            return self.arrays[key]
        off, dtype, shape, count = self.fast[key]
        return np.frombuffer(self.buf, dtype, count, off).reshape(shape).copy()

    def _f32_rows(self, offsets: List[int], width: int) -> np.ndarray:
        """[len(offsets), width] float32 values starting at the byte
        offsets, gathered in one join over the file's bytes into a
        writeable, aligned array."""
        rows = bytearray().join([self._mv[o:o + 4 * width] for o in offsets])
        return np.frombuffer(rows, _F32).reshape(len(offsets), width)

    def columns(self, w: str, b: str, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """``w_1..w_n`` as float32, each raveled, stacked on axis 1, and the
        first element of each of ``b_1..b_n`` as float32, as a loop over the
        entries would give them: the float32 views in one gather over the
        file's bytes, the other entries from their arrays in the loop's
        order (so that the first to fail raises as it did)."""
        ws = [self.fast.get(f"{w}_{j}") for j in range(1, n + 1)]
        bs = [self.fast.get(f"{b}_{j}") for j in range(1, n + 1)]
        w_fast = [j for j, e in enumerate(ws) if e is not None and e[1] == _F32]
        b_fast = [j for j, e in enumerate(bs) if e is not None and e[1] == _F32 and e[3]]
        widths = [0 if e is None else e[3] for e in ws]
        w_slow: Dict[int, np.ndarray] = {}
        b_slow: Dict[int, float] = {}
        if len(w_fast) < n or len(b_fast) < n:
            w_set, b_set = set(w_fast), set(b_fast)
            for j in range(n):
                if j not in w_set:
                    col = w_slow[j] = np.asarray(self[f"{w}_{j + 1}"], np.float32).ravel()
                    widths[j] = col.size
                if j not in b_set:
                    b_slow[j] = float(np.asarray(self[f"{b}_{j + 1}"]).ravel()[0])
        if len(set(widths)) > 1:  # np.stack refuses them: let it say so
            np.stack([np.asarray(self[f"{w}_{j}"], np.float32).ravel()
                      for j in range(1, n + 1)], axis=1)
        rows = np.empty((n, widths[0]), np.float32)
        rows[w_fast] = self._f32_rows([ws[j][0] for j in w_fast], widths[0])
        for j, col in w_slow.items():
            rows[j] = col
        # Each bias passes through a double, as float() passes it (which
        # quiets a signalling NaN, and warns of nothing).
        biases = np.empty(n, np.float64)
        with np.errstate(invalid="ignore"):
            biases[b_fast] = self._f32_rows([bs[j][0] for j in b_fast], 1)[:, 0]
        for j, v in b_slow.items():
            biases[j] = v
        return np.ascontiguousarray(rows.T), biases.astype(np.float32)


@contextlib.contextmanager
def _open_npz(path: str) -> Iterator[_Npz]:
    """The checked and classified entries of the npz at ``path``, with the
    file open for the fallback entries' decoding."""
    cap = _max_entry_bytes()
    total_cap = _max_total_bytes(cap)
    with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
        yield _Npz(f, zf, cap, total_cap)


def load(path: str, device=None) -> SpeakerNet:
    """Deserialize ``model.npz`` (src/lib.rs:1132-1281) onto ``device``
    (``cuda`` unless ``'cpu'`` is asked for).

    Raise-or-load contract: a malformed file (truncated, bit-flipped, wrong
    dtypes/shapes, missing core entries) raises BEFORE any state is built,
    so a failed load never partially applies."""
    # The span's arguments: the entries, and those that np.load decodes.
    with _open_npz(path) as data, span(
        "load.read", len(data.fast) + len(data.fallback), len(data.fallback)
    ):
        data.decode()
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
        idx = 1
        while f"w3_{idx}" in data and f"b3_{idx}" in data:
            idx += 1

        hidden2 = w2.shape[1]
        if idx > 1:
            w3_live, b3_live = data.columns("w3", "b3", idx - 1)
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
        idx4 = 1
        while f"w4_{idx4}" in data and f"b4_{idx4}" in data:
            idx4 += 1
        w4, b4 = data.columns("w4", "b4", idx4 - 1) if idx4 > 1 else (None, None)

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
