"""Data Manager (paper §3.1): inter- and cross-provider data operations via a
unified API — copy, move, link, delete, list — plus checkpoint staging.

Each provider has a *site store* (a directory namespace); a *shared* store
models the cross-site object store.  On a real fleet these verbs map to the
pod-local SSD / pod NFS / cross-region object store; the API is identical.

Two hard edges, learned the hard way:

  * Sites must be ``register_site``-ed before any verb touches them: a typo'd
    destination used to silently mint a brand-new site directory, and the
    "staged" data was never seen again.  Unknown sites now raise
    ``UnknownSiteError``.
  * Path containment is checked with ``os.path.commonpath``, not a string
    prefix: ``startswith`` without a trailing separator let ``../ab/x``
    escape site ``a`` into a sibling site ``ab``.

When a ``DatasetRegistry`` (core/staging.py) is attached, the physical verbs
keep the logical replica map coherent: a copy/move/link whose relative path
names a registered dataset records (or drops) the replica at the touched
sites, so modeled placement and on-disk reality do not drift apart.
"""
from __future__ import annotations

import os
import shutil

from repro_torch.runtime.tracing import Trace


class UnknownSiteError(ValueError):
    """A verb named a site that was never ``register_site``-ed."""


class DataManager:
    def __init__(self, root: str):
        self.root = root
        self.trace = Trace()
        self._sites: set[str] = {"shared"}
        self.registry = None  # optional DatasetRegistry (core/staging.py)
        os.makedirs(os.path.join(root, "shared"), exist_ok=True)

    def attach_registry(self, registry) -> None:
        """Couple physical ops to the staging layer's logical replica map."""
        self.registry = registry

    def register_site(self, provider: str) -> str:
        self._sites.add(provider)
        path = self._site(provider)
        os.makedirs(path, exist_ok=True)
        return path

    def deregister_site(self, provider: str) -> None:
        """The site's provider is gone: further verbs naming it must raise
        (UnknownSiteError) instead of silently stranding data in a dead
        directory.  The files themselves are left for the workdir cleanup."""
        self._sites.discard(provider)

    def _site(self, site: str) -> str:
        if site not in self._sites:
            raise UnknownSiteError(
                f"unknown site {site!r}: register_site() it first "
                f"(known: {sorted(self._sites)})"
            )
        return os.path.join(self.root, site)

    def _resolve(self, site: str, rel: str) -> str:
        base = os.path.normpath(self._site(site))
        path = os.path.normpath(os.path.join(base, rel))
        # commonpath, NOT startswith: "a/../ab" shares the "a" string prefix
        # with site "a" but is NOT contained in it
        if os.path.commonpath([base, path]) != base:
            raise ValueError(f"path escape: {site}:{rel}")
        return path

    # -- logical replica coherence (no-ops without a registry) -----------
    def _note_replica(self, site: str, rel: str) -> None:
        if self.registry is not None and self.registry.known(rel):
            from repro_torch.core.staging import StagingError

            try:
                self.registry.place_replica(rel, site)
            except StagingError:
                pass  # site unknown to the model, or modeled scratch full

    def _drop_replica(self, site: str, rel: str) -> None:
        if self.registry is not None and self.registry.known(rel):
            self.registry.drop_replica(rel, site)

    # -- the paper's five verbs ------------------------------------------
    def copy(self, src_site: str, src: str, dst_site: str, dst: str) -> str:
        s, d = self._resolve(src_site, src), self._resolve(dst_site, dst)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        if os.path.isdir(s):
            shutil.copytree(s, d, dirs_exist_ok=True)
        else:
            shutil.copy2(s, d)
        self._note_replica(dst_site, dst)
        self.trace.add(f"copy:{src_site}:{src}->{dst_site}:{dst}")
        return d

    def move(self, src_site: str, src: str, dst_site: str, dst: str) -> str:
        s, d = self._resolve(src_site, src), self._resolve(dst_site, dst)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        shutil.move(s, d)
        self._drop_replica(src_site, src)
        self._note_replica(dst_site, dst)
        self.trace.add(f"move:{src_site}:{src}->{dst_site}:{dst}")
        return d

    def link(self, src_site: str, src: str, dst_site: str, dst: str) -> str:
        """Zero-copy intra-filesystem staging (same-site fast path)."""
        s, d = self._resolve(src_site, src), self._resolve(dst_site, dst)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        if os.path.lexists(d):
            os.unlink(d)
        os.symlink(os.path.abspath(s), d)
        self._note_replica(dst_site, dst)
        self.trace.add(f"link:{src_site}:{src}->{dst_site}:{dst}")
        return d

    def delete(self, site: str, rel: str) -> None:
        p = self._resolve(site, rel)
        if os.path.isdir(p) and not os.path.islink(p):
            shutil.rmtree(p)
        elif os.path.lexists(p):
            os.unlink(p)
        self._drop_replica(site, rel)
        self.trace.add(f"delete:{site}:{rel}")

    def list(self, site: str, rel: str = ".") -> list[str]:
        p = self._resolve(site, rel)
        if not os.path.isdir(p):
            return []
        return sorted(os.listdir(p))

    def exists(self, site: str, rel: str) -> bool:
        return os.path.lexists(self._resolve(site, rel))

    def put_bytes(self, site: str, rel: str, payload: bytes) -> str:
        p = self._resolve(site, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(payload)
        self._note_replica(site, rel)
        return p

    def get_bytes(self, site: str, rel: str) -> bytes:
        with open(self._resolve(site, rel), "rb") as f:
            return f.read()

    # -- checkpoint staging ------------------------------------------------
    def stage_checkpoint(self, provider: str, ckpt_dir: str, step: int) -> str:
        """Stage a local checkpoint step dir to the shared store (async save
        path calls this after the write completes)."""
        name = f"step_{step:08d}"
        src = os.path.join(ckpt_dir, name)
        dst = self._resolve("shared", os.path.join("ckpt", provider, name))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst)
        self.trace.add(f"stage_ckpt:{provider}:{step}")
        return dst
