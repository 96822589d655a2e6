"""Server authentication: credentials graph + HMAC tokens — the port's
copy of ``janusgraph_tpu/server/auth.py``; a password hash or a token
one package makes verifies in the other.

Capability parity with the reference's authenticators
(reference: janusgraph-server .../gremlin/server/auth/
JanusGraphSimpleAuthenticator.java — username/password against a credentials
graph with hashed passwords; HMACAuthenticator.java — issues time-limited
HMAC tokens clients replay instead of credentials;
SaslAndHMACAuthenticator.java combines both — here CredentialsAuthenticator
and HMACAuthenticator compose the same way).

Passwords are stored as PBKDF2-HMAC-SHA256 (salt:iterations:hash) on user
vertices in the credentials graph. Tokens are `base64(user|expiry|hmac)`.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Optional

from janusgraph_tpu_torch.exceptions import JanusGraphTorchError


class AuthenticationError(JanusGraphTorchError):
    pass


_ITERATIONS = 10_000


def hash_password(password: str, iterations: int = _ITERATIONS) -> str:
    salt = os.urandom(16)
    dk = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, iterations
    )
    return f"{salt.hex()}:{iterations}:{dk.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        salt_hex, iters, dk_hex = stored.split(":")
    except ValueError:
        return False
    dk = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), bytes.fromhex(salt_hex), int(iters)
    )
    return hmac.compare_digest(dk.hex(), dk_hex)


class CredentialsAuthenticator:
    """Username/password auth backed by a credentials graph (reference:
    JanusGraphSimpleAuthenticator + credentials-graph convention: vertices
    labeled 'user' with 'username'/'password' properties)."""

    USER_LABEL = "user"

    def __init__(self, credentials_graph):
        self.graph = credentials_graph
        self._ensure_schema()

    def _ensure_schema(self) -> None:
        g = self.graph
        if g.schema_cache.get_by_name("username") is None:
            mgmt = g.management()
            mgmt.make_property_key("username", str)
            mgmt.make_property_key("password", str)
            mgmt.make_vertex_label(self.USER_LABEL)
            mgmt.build_composite_index("by_username", ["username"], unique=True)

    def create_user(self, username: str, password: str) -> None:
        src = self.graph.traversal()
        if src.V().has("username", username).to_list():
            src.rollback()
            raise AuthenticationError(f"user {username!r} exists")
        v = src.add_v(self.USER_LABEL)
        v.property("username", username)
        v.property("password", hash_password(password))
        src.commit()

    def remove_user(self, username: str) -> None:
        src = self.graph.traversal()
        for v in src.V().has("username", username).to_list():
            v.remove()
        src.commit()

    def authenticate(self, username: str, password: str) -> str:
        src = self.graph.traversal()
        hits = src.V().has("username", username).values("password").to_list()
        src.rollback()
        if not hits or not verify_password(password, hits[0]):
            raise AuthenticationError("invalid credentials")
        return username


class HMACAuthenticator:
    """Time-limited token issue/verify on top of any credential check
    (reference: HMACAuthenticator.java — token = HMAC over user + expiry)."""

    def __init__(
        self,
        credentials: CredentialsAuthenticator,
        secret: Optional[bytes] = None,
        token_ttl_seconds: float = 3600.0,
    ):
        self.credentials = credentials
        self.secret = secret or os.urandom(32)
        self.token_ttl = token_ttl_seconds

    def issue_token(self, username: str, password: str) -> str:
        self.credentials.authenticate(username, password)
        expiry = int((time.time() + self.token_ttl) * 1000)
        payload = base64.urlsafe_b64encode(
            json.dumps({"u": username, "e": expiry}).encode()
        ).decode()
        sig = hmac.new(self.secret, payload.encode(), hashlib.sha256).hexdigest()
        return f"{payload}.{sig}"

    def verify_token(self, token: str) -> str:
        try:
            payload, sig = token.rsplit(".", 1)
            claims = json.loads(base64.urlsafe_b64decode(payload.encode()))
            username, expiry = claims["u"], int(claims["e"])
        except Exception:
            raise AuthenticationError("malformed token")
        want = hmac.new(self.secret, payload.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise AuthenticationError("bad token signature")
        if time.time() * 1000 > expiry:
            raise AuthenticationError("token expired")
        return username


class SaslAndHMACAuthenticator(HMACAuthenticator):
    """Combined authenticator: one instance answers BOTH username/password
    (SASL-PLAIN-shaped Basic auth) and HMAC token requests (reference:
    gremlin/server/auth/SaslAndHMACAuthenticator.java — the reference
    registers this combination as one authenticator; here the server's
    authenticate_request dispatches on the Authorization scheme, so the
    combined class IS an HMACAuthenticator whose credentials checker backs
    the Basic path). Named for discoverability/parity."""
