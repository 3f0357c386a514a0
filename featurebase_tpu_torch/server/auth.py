"""OIDC-shaped authentication + per-index group authorization.

Reference: authn/authn.go:1 — OAuth2/OIDC middleware that validates the
IdP's signed access token on every request — and authz/authz.go:14 — a
group-id -> {index -> permission} map loaded from YAML, with permission
levels read < write < admin.

Own copy of featurebase_tpu/server/auth.py.  Tokens are verified OFFLINE (HS256 shared secret or RS256
public key via `cryptography`) so the query hot path never round-trips to
an IdP; grants are an in-memory map (JSON file or dict).  The legacy static
bearer token (api.auth_token) remains as the cluster-internal credential,
equivalent to an admin grant.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Dict, List, Optional

PERM_ORDER = {"read": 1, "write": 2, "admin": 3}


class AuthError(Exception):
    def __init__(self, msg: str, status: int = 401):
        super().__init__(msg)
        self.status = status


class UserInfo:
    __slots__ = ("name", "groups")

    def __init__(self, name: str, groups: List[str]):
        self.name = name
        self.groups = list(groups)


def _b64url_decode(s: str) -> bytes:
    pad = (-len(s)) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


class TokenVerifier:
    """Offline JWT verification (the authn.go access-token check).

    Exactly one of `secret` (HS256) or `public_key_pem` (RS256) must be
    set; the token's alg header must match the configured scheme (no
    algorithm-confusion downgrade)."""

    def __init__(self, secret: Optional[str] = None,
                 public_key_pem: Optional[bytes] = None,
                 issuer: Optional[str] = None,
                 audience: Optional[str] = None,
                 groups_claim: str = "groups",
                 name_claim: str = "sub",
                 leeway: float = 30.0):
        if bool(secret) == bool(public_key_pem):
            raise ValueError("configure exactly one of secret (HS256) or "
                             "public_key_pem (RS256)")
        self.secret = secret.encode() if isinstance(secret, str) else secret
        self.public_key = None
        if public_key_pem:
            from cryptography.hazmat.primitives.serialization import \
                load_pem_public_key
            self.public_key = load_pem_public_key(public_key_pem)
        self.alg = "HS256" if secret else "RS256"
        self.issuer = issuer
        self.audience = audience
        self.groups_claim = groups_claim
        self.name_claim = name_claim
        self.leeway = leeway

    def verify(self, token: str) -> UserInfo:
        if not token:
            raise AuthError("missing bearer token")
        parts = token.split(".")
        if len(parts) != 3:
            raise AuthError("malformed token")
        signing_input = (parts[0] + "." + parts[1]).encode()
        try:
            header = json.loads(_b64url_decode(parts[0]))
            claims = json.loads(_b64url_decode(parts[1]))
            sig = _b64url_decode(parts[2])
        except Exception:  # noqa: BLE001
            raise AuthError("malformed token")
        if header.get("alg") != self.alg:
            raise AuthError(f"token alg {header.get('alg')!r} not accepted")
        if self.alg == "HS256":
            want = hmac.new(self.secret, signing_input,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise AuthError("bad signature")
        else:
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives.asymmetric.padding import \
                PKCS1v15
            from cryptography.hazmat.primitives.hashes import SHA256
            try:
                self.public_key.verify(sig, signing_input, PKCS1v15(),
                                       SHA256())
            except InvalidSignature:
                raise AuthError("bad signature")
        now = time.time()
        exp = claims.get("exp")
        if exp is not None and now > float(exp) + self.leeway:
            raise AuthError("token expired")
        nbf = claims.get("nbf")
        if nbf is not None and now < float(nbf) - self.leeway:
            raise AuthError("token not yet valid")
        if self.issuer and claims.get("iss") != self.issuer:
            raise AuthError("wrong issuer")
        if self.audience:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise AuthError("wrong audience")
        groups = claims.get(self.groups_claim) or []
        if isinstance(groups, str):
            groups = [groups]
        return UserInfo(str(claims.get(self.name_claim, "")), groups)


class GroupAuthorizer:
    """group -> {index -> permission} grants (authz.go:14 GroupPermissions).

    '*' as an index key grants the level on every index; admin_group
    short-circuits to admin everywhere."""

    def __init__(self, grants: Dict[str, Dict[str, str]],
                 admin_group: Optional[str] = None):
        for g, idxs in grants.items():
            for idx, p in idxs.items():
                if p not in PERM_ORDER:
                    raise ValueError(f"bad permission {p!r} for {g}/{idx}")
        self.grants = grants
        self.admin_group = admin_group

    @classmethod
    def from_file(cls, path: str) -> "GroupAuthorizer":
        with open(path) as fh:
            doc = json.load(fh)
        return cls(doc.get("user-groups", doc.get("grants", {})),
                   admin_group=doc.get("admin"))

    def _level(self, user: UserInfo, index: str) -> int:
        if self.admin_group and self.admin_group in user.groups:
            return PERM_ORDER["admin"]
        best = 0
        for g in user.groups:
            idxs = self.grants.get(g)
            if not idxs:
                continue
            for key in (index, "*"):
                p = idxs.get(key)
                if p:
                    best = max(best, PERM_ORDER[p])
        return best

    def allowed(self, user: UserInfo, index: Optional[str],
                level: str) -> bool:
        need = PERM_ORDER[level]
        if index is not None:
            return self._level(user, index) >= need
        # no specific index: any grant at the level suffices (schema/status
        # style endpoints; per-index data still gets per-index checks)
        if self.admin_group and self.admin_group in user.groups:
            return True
        for idxs in (self.grants.get(g, {}) for g in user.groups):
            for p in idxs.values():
                if PERM_ORDER[p] >= need:
                    return True
        return False


class Auth:
    """Bundle wired onto the API: verifier + authorizer."""

    def __init__(self, verifier: TokenVerifier,
                 authorizer: GroupAuthorizer):
        self.verifier = verifier
        self.authorizer = authorizer

    def check(self, bearer: str, index: Optional[str], level: str
              ) -> UserInfo:
        """Verify the Authorization header value and enforce the grant;
        raises AuthError(401) on bad tokens, AuthError(403) on missing
        permission."""
        token = bearer
        if token.lower().startswith("bearer "):
            token = token[7:].strip()
        user = self.verifier.verify(token)
        if not self.authorizer.allowed(user, index, level):
            raise AuthError(
                f"user {user.name or '<anon>'} lacks {level} on "
                f"{index or 'any index'}", 403)
        return user


# -- route -> required access mapping (the authn middleware's perm table,
# reference: http_handler.go routes x authz checks) --------------------------

_WRITE_PQL = ("Set(", "Clear(", "ClearRow(", "Store(", "Delete(")


def pql_access_level(pql: str) -> str:
    """'write' if the query contains any mutating call, else 'read'.
    Conservative: a false positive only raises the required level."""
    compact = "".join(pql.split())
    return "write" if any(w in compact for w in _WRITE_PQL) else "read"


def sql_access(sql: str):
    """-> (index_or_None, level) for a SQL statement."""
    import re
    s = sql.strip()
    head = s.split(None, 1)[0].upper() if s else ""
    if head in ("SELECT", "SHOW", "EXPLAIN"):
        m = re.search(r"\bFROM\s+([A-Za-z_][\w]*)", s, re.I)
        return (m.group(1) if m else None), "read"
    if head in ("INSERT", "BULK", "COPY", "DELETE", "UPDATE"):
        m = re.search(r"\b(?:INTO|FROM|UPDATE)\s+([A-Za-z_][\w]*)", s, re.I)
        return (m.group(1) if m else None), "write"
    return None, "admin"  # DDL


def route_access(method: str, path: str, pql: str = "", sql: str = ""):
    """-> (index_or_None, level) required for an HTTP route."""
    import re
    if path.startswith("/internal/"):
        return None, "admin"
    m = re.fullmatch(r"/index/([^/]+)/query", path)
    if m:
        return m.group(1), pql_access_level(pql)
    if path == "/sql":
        return sql_access(sql)
    m = re.fullmatch(r"/index/([^/]+)(/field/[^/]+)?", path)
    if m:
        if method in ("POST", "DELETE"):
            return m.group(1), "admin"
        return m.group(1), "read"
    m = re.match(r"/index/([^/]+)/", path)
    if m:
        level = "write" if method == "POST" else "read"
        return m.group(1), level
    if method in ("POST", "DELETE") and path not in ("/sql",):
        return None, "admin"  # schema apply, restore, etc.
    return None, "read"


def mint_hs256(secret: str, sub: str, groups: List[str],
               ttl: float = 3600.0, issuer: Optional[str] = None,
               audience: Optional[str] = None,
               groups_claim: str = "groups") -> str:
    """Mint an HS256 JWT accepted by TokenVerifier (reference:
    `featurebase auth-token` prints a token for the configured auth)."""
    import base64
    import hashlib
    import hmac
    import json as _json
    import time as _time

    def b64url(b: bytes) -> str:
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

    header = {"alg": "HS256", "typ": "JWT"}
    claims = {"sub": sub, groups_claim: groups,
              "iat": int(_time.time()),
              "exp": int(_time.time() + ttl)}
    if issuer:
        claims["iss"] = issuer
    if audience:
        claims["aud"] = audience
    signing = (b64url(_json.dumps(header).encode()) + "." +
               b64url(_json.dumps(claims).encode()))
    sig = hmac.new(secret.encode(), signing.encode(),
                   hashlib.sha256).digest()
    return signing + "." + b64url(sig)
