"""Unified path abstraction over local files, fsspec remotes, and GDC manifests.

Re-creation of the reference's URI layer (reference: wsinsight/uri_path.py:23-857)
with the same three schemes and behaviors:

* local filesystem paths (default),
* fsspec-backed remotes (``s3://``, ``gs://``, ``abfs://`` …),
* ``gdc-manifest://<manifest.tsv>`` — a GDC manifest TSV exposed as a virtual
  directory of TCGA files, downloaded on demand from
  ``https://api.gdc.cancer.gov/data/{uuid}`` with retry/backoff and MD5
  verification (reference: wsinsight/uri_path.py:227-274,524-542).

Shared behaviors preserved:

* ``materialize()`` downloads to a content-hashed cache dir (``~/.cache`` or
  ``$WSINSIGHT_REMOTE_CACHE_DIR``) with temp-file + ``os.replace`` atomicity
  (reference: uri_path.py:473-500).
* ``open()`` in write modes returns a proxy that uploads the local cache back to
  the remote on close (reference: uri_path.py:205-215,829-857).
* pathlib surface: ``/`` join, name/stem/suffix/parent/parts, with_suffix,
  with_name, ordering and hashing by canonical URI.
* ``URIPathType`` click param with optional existence checks
  (reference: uri_path.py:808-826).

Env config: ``S3_STORAGE_OPTIONS`` (JSON kwargs for fsspec) and
``WSINSIGHT_REMOTE_CACHE_DIR``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
import time
import weakref
from pathlib import Path, PurePosixPath
from typing import IO, Iterator

import click

logger = logging.getLogger(__name__)

_REMOTE_SCHEMES = ("s3", "gs", "gcs", "abfs", "az", "http", "https", "ftp")
GDC_SCHEME = "gdc-manifest"
GDC_API = "https://api.gdc.cancer.gov/data/"


def _default_cache_dir() -> Path:
    env = os.getenv("WSINSIGHT_REMOTE_CACHE_DIR")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "wsinsight_tpu" / "remote"


# Credential sets already proven good this process (see _check_credentials).
_CREDENTIALS_OK: set = set()


def _check_credentials(scheme: str, storage_options: dict, uri: str) -> None:
    """Fail fast on bad remote credentials, once per credential set.

    Matches the reference's eager constructor validation (reference:
    wsinsight/uri_path.py:424-464): a GDC token gets a tiny authenticated
    HEAD against the API, fsspec remotes get their filesystem initialised —
    so a bad token or key dies at CLI-parse time instead of hours into a
    cohort run. Unlike the reference this is memoised per
    (scheme, options, token) so path joins don't repeat network calls,
    and a missing optional backend package (e.g. no s3fs installed) defers
    to the lazy error at first access rather than failing eagerly.
    """
    if scheme == GDC_SCHEME:
        token = os.getenv("GDC_TOKEN")
        if not token:
            return
        key = (GDC_SCHEME, token)
        if key in _CREDENTIALS_OK:
            return
        import requests

        try:
            resp = requests.head(
                GDC_API,
                headers={"X-Auth-Token": token, "Accept": "application/octet-stream"},
                timeout=8,
            )
        except Exception as e:
            # Unreachable API proves nothing about the token; the download
            # path retries with backoff and raises descriptively if it is a
            # real outage. Only a definitive auth rejection is fatal here.
            logger.warning(f"GDC credential pre-check skipped (API unreachable: {e!r})")
            return
        if resp.status_code in (401, 403):
            raise RuntimeError(f"GDC token rejected (status {resp.status_code})")
        _CREDENTIALS_OK.add(key)
        return

    key = (scheme, tuple(sorted((str(k), str(v)) for k, v in storage_options.items())))
    if key in _CREDENTIALS_OK:
        return
    try:
        import fsspec

        fsspec.filesystem(scheme, **storage_options)
    except ImportError:
        # Backend package not installed — not a credential problem; the
        # first real access raises the descriptive fsspec error.
        return
    except Exception as e:
        raise RuntimeError(f"remote filesystem init failed for {uri!r}: {e!r}") from e
    _CREDENTIALS_OK.add(key)


def _split_scheme(uri: str) -> tuple[str | None, str]:
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme.lower(), rest
    return None, uri


class _SyncOnCloseFile:
    """File proxy that uploads a local cache file to the remote on close."""

    def __init__(self, local_fh: IO, upload):
        self._fh = local_fh
        self._upload = upload
        self._closed = False

    def __getattr__(self, item):
        return getattr(self._fh, item)

    def close(self) -> None:
        if not self._closed:
            self._fh.close()
            self._upload()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class URIPath:
    """Pathlib-like object spanning local, fsspec-remote, and GDC schemes."""

    __slots__ = (
        "_uri",
        "scheme",
        "_path",
        "storage_options",
        "cache_dir",
        "_gdc_manifest",
        "_gdc_entry",
        "__weakref__",
    )

    def __init__(
        self,
        uri: "URIPath | str | os.PathLike",
        storage_options: dict | None = None,
        cache_dir: "str | Path | None" = None,
    ):
        if isinstance(uri, URIPath):
            self._uri = uri._uri
            self.scheme = uri.scheme
            self._path = uri._path
            self.storage_options = dict(uri.storage_options)
            self.cache_dir = Path(cache_dir) if cache_dir else uri.cache_dir
            self._gdc_manifest = uri._gdc_manifest
            self._gdc_entry = uri._gdc_entry
            return
        uri = os.fspath(uri)
        scheme, rest = _split_scheme(str(uri))
        if storage_options is None:
            env_opts = os.getenv("S3_STORAGE_OPTIONS")
            storage_options = json.loads(env_opts) if env_opts else {}
        self.storage_options = storage_options
        self.cache_dir = Path(cache_dir) if cache_dir else _default_cache_dir()
        self._gdc_manifest = None
        self._gdc_entry = None
        if scheme == GDC_SCHEME:
            self.scheme = GDC_SCHEME
            # gdc-manifest:///path/to/manifest.tsv[/<filename-within-manifest>]
            self._path = rest
            self._uri = f"{GDC_SCHEME}://{rest}"
        elif scheme in _REMOTE_SCHEMES:
            self.scheme = scheme
            self._path = rest
            self._uri = f"{scheme}://{rest}"
        else:
            self.scheme = None  # local
            self._path = str(Path(uri).expanduser())
            self._uri = self._path
        if self.scheme is not None:
            _check_credentials(self.scheme, self.storage_options, self._uri)

    # -- identity ---------------------------------------------------------------
    def __str__(self) -> str:
        return self._uri

    def __repr__(self) -> str:
        return f"URIPath({self._uri!r})"

    def __fspath__(self) -> str:
        if self.scheme is None:
            return self._path
        return str(self.materialize())

    def __eq__(self, other) -> bool:
        return isinstance(other, URIPath) and self._uri == other._uri

    def __lt__(self, other) -> bool:
        return self._uri < str(other)

    def __hash__(self) -> int:
        return hash(self._uri)

    # -- pathlib surface ----------------------------------------------------------
    def _with_path(self, new_path: str) -> "URIPath":
        if self.scheme is None:
            out = URIPath(new_path, self.storage_options, self.cache_dir)
        else:
            out = URIPath(
                f"{self.scheme}://{new_path}", self.storage_options, self.cache_dir
            )
        return out

    def __truediv__(self, other) -> "URIPath":
        other = str(other).lstrip("/")
        base = self._path.rstrip("/")
        return self._with_path(f"{base}/{other}")

    @property
    def name(self) -> str:
        return PurePosixPath(self._path.rstrip("/")).name

    @property
    def stem(self) -> str:
        return PurePosixPath(self._path.rstrip("/")).stem

    @property
    def suffix(self) -> str:
        return PurePosixPath(self._path.rstrip("/")).suffix

    @property
    def parent(self) -> "URIPath":
        return self._with_path(str(PurePosixPath(self._path.rstrip("/")).parent))

    @property
    def parts(self) -> tuple[str, ...]:
        return PurePosixPath(self._path).parts

    def with_suffix(self, suffix: str) -> "URIPath":
        return self._with_path(str(PurePosixPath(self._path).with_suffix(suffix)))

    def with_name(self, name: str) -> "URIPath":
        return self._with_path(str(PurePosixPath(self._path).with_name(name)))

    # -- GDC manifest helpers ---------------------------------------------------
    def _gdc_parts(self) -> tuple[Path, str | None]:
        """Split a gdc-manifest URI into (manifest_path, filename | None)."""
        p = Path("/" + self._path.lstrip("/"))
        # Find the manifest file along the path (first existing .tsv/.txt ancestor).
        cur = p
        trailing: list[str] = []
        while cur != cur.parent:
            if cur.is_file():
                rel = "/".join(reversed(trailing)) if trailing else None
                return cur, rel
            trailing.append(cur.name)
            cur = cur.parent
        raise FileNotFoundError(f"GDC manifest not found along: {self._uri}")

    def _gdc_rows(self) -> list[dict[str, str]]:
        manifest, _ = self._gdc_parts()
        rows: list[dict[str, str]] = []
        with open(manifest, "r", encoding="utf-8") as fh:
            header = fh.readline().rstrip("\n").split("\t")
            for line in fh:
                vals = line.rstrip("\n").split("\t")
                if len(vals) >= 2:
                    rows.append(dict(zip(header, vals)))
        return rows

    # -- filesystem --------------------------------------------------------------
    def _fs(self):
        import fsspec

        return fsspec.filesystem(self.scheme, **self.storage_options)

    def exists(self) -> bool:
        if self.scheme is None:
            return Path(self._path).exists()
        if self.scheme == GDC_SCHEME:
            try:
                manifest, fname = self._gdc_parts()
            except FileNotFoundError:
                return False
            if fname is None:
                return True
            return any(r.get("filename") == fname for r in self._gdc_rows())
        try:
            return self._fs().exists(self._path)
        except Exception as err:
            logger.debug(f"fsspec exists() failed for {self._uri}: {err}")
            return False

    def is_file(self) -> bool:
        if self.scheme is None:
            return Path(self._path).is_file()
        if self.scheme == GDC_SCHEME:
            _, fname = self._gdc_parts()
            return fname is not None and self.exists()
        try:
            return self._fs().isfile(self._path)
        except Exception:
            return False

    def is_dir(self) -> bool:
        if self.scheme is None:
            return Path(self._path).is_dir()
        if self.scheme == GDC_SCHEME:
            _, fname = self._gdc_parts()
            return fname is None
        try:
            return self._fs().isdir(self._path)
        except Exception:
            return False

    def iterdir(
        self, recursive: bool = False, files_only: bool = False
    ) -> Iterator["URIPath"]:
        if self.scheme is None:
            base = Path(self._path)
            it = base.rglob("*") if recursive else base.iterdir()
            for p in it:
                if files_only and not p.is_file():
                    continue
                yield URIPath(str(p), self.storage_options, self.cache_dir)
        elif self.scheme == GDC_SCHEME:
            for row in self._gdc_rows():
                fname = row.get("filename")
                if fname:
                    yield self / fname
        else:
            fs = self._fs()
            entries = fs.find(self._path) if recursive else fs.ls(self._path, detail=True)
            for e in entries:
                if isinstance(e, str):
                    yield self._with_path(e)
                else:
                    if files_only and e.get("type") == "directory":
                        continue
                    yield self._with_path(e["name"])

    def mkdir(self, parents: bool = False, exist_ok: bool = False) -> None:
        if self.scheme is None:
            Path(self._path).mkdir(parents=parents, exist_ok=exist_ok)
        # Remote object stores have no real directories; creation is a no-op.

    def unlink(self, missing_ok: bool = False) -> None:
        if self.scheme is None:
            Path(self._path).unlink(missing_ok=missing_ok)
        else:
            try:
                self._fs().rm(self._path)
            except Exception:
                if not missing_ok:
                    raise

    # -- materialization ----------------------------------------------------------
    def _cache_target(self) -> Path:
        digest = hashlib.sha256(self._uri.encode()).hexdigest()[:24]
        return self.cache_dir / digest / self.name

    def materialize(self) -> Path:
        """Return a local path; download remote content to the cache if needed."""
        if self.scheme is None:
            return Path(self._path)
        target = self._cache_target()
        if target.exists() and target.stat().st_size > 0:
            return target
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp_fd, tmp_name = tempfile.mkstemp(dir=str(target.parent), suffix=".part")
        os.close(tmp_fd)
        try:
            if self.scheme == GDC_SCHEME:
                self._gdc_download(Path(tmp_name))
            else:
                self._fs().get_file(self._path, tmp_name)
            os.replace(tmp_name, target)
        finally:
            if os.path.exists(tmp_name):
                os.unlink(tmp_name)
        _register_materialized(str(target))
        return target

    def _gdc_download(self, dest: Path) -> None:
        import requests

        _, fname = self._gdc_parts()
        if fname is None:
            raise IsADirectoryError(self._uri)
        row = next((r for r in self._gdc_rows() if r.get("filename") == fname), None)
        if row is None:
            raise FileNotFoundError(self._uri)
        uuid = row.get("id")
        md5_expected = row.get("md5")
        token = os.getenv("GDC_TOKEN")
        headers = {"X-Auth-Token": token} if token else {}
        delay = 1.0
        last_err: Exception | None = None
        for _attempt in range(5):  # exponential backoff 1 -> 16 s
            try:
                with requests.get(
                    GDC_API + str(uuid), headers=headers, stream=True, timeout=120
                ) as r:
                    r.raise_for_status()
                    md5 = hashlib.md5()
                    with open(dest, "wb") as fh:
                        for chunk in r.iter_content(1 << 20):
                            fh.write(chunk)
                            md5.update(chunk)
                if md5_expected and md5.hexdigest() != md5_expected:
                    raise IOError(f"MD5 mismatch for {fname}")
                return
            except requests.HTTPError as err:
                status = getattr(err.response, "status_code", None)
                if status in (401, 403, 404):
                    # Definitive: an expired/absent token or a bad UUID never
                    # recovers on retry. 31s x N slides of backoff would hide
                    # the real cause for hours on a large manifest.
                    hint = (
                        " (check GDC_TOKEN: controlled-access file rejected)"
                        if status in (401, 403)
                        else ""
                    )
                    raise IOError(
                        f"GDC download failed for {self._uri}: HTTP {status}{hint}"
                    ) from err
                last_err = err
                time.sleep(delay)
                delay = min(delay * 2, 16.0)
            except Exception as err:
                last_err = err
                time.sleep(delay)
                delay = min(delay * 2, 16.0)
        raise IOError(f"GDC download failed for {self._uri}: {last_err}")

    # -- open ----------------------------------------------------------------------
    def open(self, mode: str = "r", **kwargs):
        if self.scheme is None:
            p = Path(self._path)
            if any(m in mode for m in ("w", "a", "+", "x")):
                p.parent.mkdir(parents=True, exist_ok=True)
            return open(p, mode, **kwargs)
        writing = any(m in mode for m in ("w", "a", "+", "x"))
        if not writing:
            return open(self.materialize(), mode, **kwargs)
        # Write mode: operate on the cache copy, sync back to remote on close.
        target = self._cache_target()
        target.parent.mkdir(parents=True, exist_ok=True)
        if ("a" in mode or "+" in mode) and "w" not in mode and self.exists():
            self.materialize()
        fh = open(target, mode, **kwargs)

        def upload(uri=self._uri, scheme=self.scheme, path=self._path, opts=self.storage_options):
            if scheme == GDC_SCHEME:
                raise PermissionError("gdc-manifest:// is read-only")
            import fsspec

            fs = fsspec.filesystem(scheme, **opts)
            fs.put_file(str(target), path)

        return _SyncOnCloseFile(fh, upload)

    def read_bytes(self) -> bytes:
        with self.open("rb") as fh:
            return fh.read()

    def read_text(self, encoding: str = "utf-8") -> str:
        return self.read_bytes().decode(encoding)

    def write_bytes(self, data: bytes) -> int:
        with self.open("wb") as fh:
            return fh.write(data)

    def write_text(self, text: str, encoding: str = "utf-8") -> int:
        return self.write_bytes(text.encode(encoding))

    def stat(self):
        if self.scheme is None:
            return Path(self._path).stat()
        return self.materialize().stat()

    def close(self) -> None:
        """Drop this URI's cached materialization, if any."""
        if self.scheme is not None:
            target = self._cache_target()
            if target.exists():
                shutil.rmtree(target.parent, ignore_errors=True)


def _cleanup_cached(path: str) -> None:
    try:
        parent = os.path.dirname(path)
        if os.path.exists(path):
            os.unlink(path)
        if parent and os.path.isdir(parent) and not os.listdir(parent):
            os.rmdir(parent)
    except OSError:
        pass


# Materialized cache files are cleaned up once, at PROCESS EXIT — not per
# URIPath GC like the reference (uri_path.py:753-805), whose finalizers can
# delete a file the moment a loop-local URIPath goes out of scope while a
# worker still holds the returned Path. WSINSIGHT_KEEP_REMOTE_CACHE=1 keeps
# the content-hashed cache across processes (e.g. patch stage then infer
# stage over the same TCGA slides downloads once).
_MATERIALIZED: set = set()
_ATEXIT_REGISTERED = False


def _register_materialized(path: str) -> None:
    global _ATEXIT_REGISTERED
    _MATERIALIZED.add(path)
    if not _ATEXIT_REGISTERED:
        import atexit

        atexit.register(_cleanup_materialized_at_exit)
        _ATEXIT_REGISTERED = True


def _cleanup_materialized_at_exit() -> None:
    if os.getenv("WSINSIGHT_KEEP_REMOTE_CACHE", "0") not in ("0", ""):
        return
    for p in list(_MATERIALIZED):
        _cleanup_cached(p)


class URIPathType(click.ParamType):
    """Click parameter type converting strings to URIPath with existence checks.

    Local paths honor ``exists=True``; remote output dirs are accepted without a
    round-trip (reference: wsinsight/uri_path.py:808-826).
    """

    name = "uripath"

    def __init__(
        self,
        exists: bool = False,
        file_okay: bool = True,
        dir_okay: bool = True,
        storage_options: dict | None = None,
        cache_dir: "str | Path | None" = None,
    ):
        self.exists = exists
        self.file_okay = file_okay
        self.dir_okay = dir_okay
        self.storage_options = storage_options
        self.cache_dir = cache_dir

    def convert(self, value, param, ctx):
        if isinstance(value, URIPath):
            return value
        try:
            p = URIPath(value, storage_options=self.storage_options, cache_dir=self.cache_dir)
        except Exception as err:
            self.fail(f"invalid URI {value!r}: {err}", param, ctx)
        if self.exists and p.scheme is None and not p.exists():
            self.fail(f"{value!r} does not exist.", param, ctx)
        if p.scheme is None:
            if not self.file_okay and p.is_file():
                self.fail(f"{value!r} is a file, expected a directory.", param, ctx)
            if not self.dir_okay and p.is_dir():
                self.fail(f"{value!r} is a directory, expected a file.", param, ctx)
        return p
