"""Reference-demo downloader.

The counterpart of ``magical_tpu/data/reference_demos.py`` (after the
reference's magical/reference_demos.py): fetch
github.com/qxcv/magical-data and extract it into a local `demos/`
directory with a `.download-done` marker.  The extraction is its own
function, `extract_demos`, so that an archive fetched some other way (on a
machine without network) unpacks the same way.  Uses urllib (no
`requests` dependency); where the download fails, `try_download_demos`
raises `DownloadError`.
"""

from __future__ import annotations

import io
import os
import sys
import urllib.request
import zipfile

DEMO_URL = 'https://github.com/qxcv/magical-data/archive/master.zip'
DONE_MARKER = '.download-done'


class DownloadError(Exception):
    pass


def _download(progress=True) -> bytes:
    """The archive at DEMO_URL, as bytes."""
    try:
        with urllib.request.urlopen(DEMO_URL) as resp:
            total = resp.headers.get('Content-Length')
            chunks = []
            read = 0
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                chunks.append(chunk)
                read += len(chunk)
                if progress:
                    tot = f'/{int(total)//(1<<20)}MiB' if total else ''
                    print(f'\rdownloaded {read>>20}MiB{tot}', end='',
                          file=sys.stderr)
    except Exception as ex:          # pragma: no cover - network dependent
        raise DownloadError(
            f'could not download demos from {DEMO_URL}: {ex}') from ex
    if progress:
        print(file=sys.stderr)
    return b''.join(chunks)


def extract_demos(zip_bytes_or_path, dest='demos'):
    """Unpack a magical-data archive (its bytes, or a path to it) into
    `dest`, stripping the leading path component of every member (the
    archive's "magical-data-master/"), and write the `.download-done`
    marker; returns `dest`."""
    src = io.BytesIO(zip_bytes_or_path) \
        if isinstance(zip_bytes_or_path, (bytes, bytearray)) \
        else zip_bytes_or_path
    os.makedirs(dest, exist_ok=True)
    root = os.path.realpath(dest)
    with zipfile.ZipFile(src) as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            parts = info.filename.split('/')[1:]
            if not parts:
                continue
            out_path = os.path.join(dest, *parts)
            if not os.path.realpath(out_path).startswith(root + os.sep):
                raise ValueError(f'archive member {info.filename!r} would '
                                 f'land outside {dest!r}')
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with zf.open(info) as fin, open(out_path, 'wb') as fout:
                fout.write(fin.read())
    with open(os.path.join(dest, DONE_MARKER), 'w') as f:
        f.write('done\n')
    return dest


def try_download_demos(dest='demos', progress=True):
    """reference_demos.py:44-129 — idempotent download + extract."""
    if os.path.exists(os.path.join(dest, DONE_MARKER)):
        return dest
    return extract_demos(_download(progress), dest)


def _main():                          # pragma: no cover - CLI
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--dest', default='demos')
    args = p.parse_args()
    try_download_demos(args.dest)


if __name__ == '__main__':            # pragma: no cover
    _main()
