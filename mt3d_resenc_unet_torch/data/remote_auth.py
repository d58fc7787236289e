"""Credentials and request signatures for private buckets, as the JAX
package's tensorstore ``s3`` and ``gcs`` kvstores send them.

* ``s3://``: AWS Signature Version 4 (:func:`sign_s3`, :func:`s3_headers`)
  with the credentials :func:`aws_credentials` finds, in the order
  tensorstore's AWS chain takes them: the environment
  (``AWS_ACCESS_KEY_ID``, ``AWS_SECRET_ACCESS_KEY``, ``AWS_SESSION_TOKEN``),
  then the profile ``AWS_PROFILE`` (``default``) of
  ``AWS_SHARED_CREDENTIALS_FILE`` (``~/.aws/credentials``) and
  ``AWS_CONFIG_FILE`` (``~/.aws/config``, section ``profile <name>``);
  with none, requests go unsigned, as tensorstore sends them to a public
  bucket. The web-identity, container (ECS) and EC2 instance sources of
  tensorstore's chain are not read.
* ``gs://``: an OAuth2 bearer token (:func:`gcs_authorization`) from, in
  tensorstore's order, ``GOOGLE_AUTH_TOKEN_FOR_TESTING`` (a fixed token);
  the JSON file ``GOOGLE_APPLICATION_CREDENTIALS`` names, else gcloud's
  ``application_default_credentials.json`` (under ``CLOUDSDK_CONFIG`` or
  ``~/.config/gcloud``): a ``service_account`` key (a JWT-bearer grant
  signed RS256 here, in pure Python) or an ``authorized_user`` (a
  ``refresh_token`` grant), both posted to :data:`GOOGLE_TOKEN_URL`; the
  metadata server (``GCE_METADATA_ROOT``, else
  :data:`GCE_METADATA_HOST`); with none, anonymous. A token is kept until
  :data:`TOKEN_MARGIN_S` before it expires.

Only the standard library. No message this module raises or prints
carries a key, a secret, a token or a signature.
"""

from __future__ import annotations

import base64
import configparser
import dataclasses
import datetime
import hashlib
import hmac
import http.client
import json
import os
import threading
import time
import urllib.parse
from typing import Dict, Optional, Tuple

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()

# tensorstore's token endpoint, which it also puts in a JWT's "aud" (it
# does not read a key file's "token_uri"); the scope its service-account
# grant asks for
GOOGLE_TOKEN_URL = "https://www.googleapis.com/oauth2/v3/token"
GOOGLE_TOKEN_AUDIENCE = "https://www.googleapis.com/oauth2/v3/token"
GCS_SCOPE = "https://www.googleapis.com/auth/cloud-platform"
GCE_METADATA_HOST = "metadata.google.internal"
JWT_LIFETIME_S = 3600
TOKEN_MARGIN_S = 60
_JWT_GRANT = "urn%3Aietf%3Aparams%3Aoauth%3Agrant-type%3Ajwt-bearer"


# ------------------------------------------------------------------ S3

@dataclasses.dataclass(frozen=True)
class AwsCredentials:
    """An access key with its secret (and a session token), and where it
    was found; ``repr`` shows neither secret nor token."""

    access_key: str
    secret_key: str = dataclasses.field(repr=False)
    session_token: Optional[str] = dataclasses.field(default=None,
                                                     repr=False)
    source: str = "environment"


def _ini_section(path: str, section: str) -> Dict[str, str]:
    parser = configparser.ConfigParser(interpolation=None, strict=False,
                                       default_section="\0")
    try:
        parser.read(path, encoding="utf-8")
    except (configparser.Error, OSError, UnicodeDecodeError):
        return {}
    return dict(parser[section]) if parser.has_section(section) else {}


def aws_credentials() -> Optional[AwsCredentials]:
    """The credentials an S3 request is signed with, or None (unsigned)."""
    env = os.environ
    key = env.get("AWS_ACCESS_KEY_ID")
    secret = env.get("AWS_SECRET_ACCESS_KEY")
    if key and secret:
        return AwsCredentials(key, secret,
                              env.get("AWS_SESSION_TOKEN") or None)
    name = env.get("AWS_PROFILE") or "default"
    home = env.get("HOME") or os.path.expanduser("~")
    config = env.get("AWS_CONFIG_FILE") or os.path.join(home, ".aws", "config")
    shared = (env.get("AWS_SHARED_CREDENTIALS_FILE")
              or os.path.join(home, ".aws", "credentials"))
    fields = _ini_section(config, f"profile {name}")
    if name == "default":
        fields = {**_ini_section(config, "default"), **fields}
    fields.update(_ini_section(shared, name))
    key = fields.get("aws_access_key_id")
    secret = fields.get("aws_secret_access_key")
    if key and secret:
        return AwsCredentials(key, secret,
                              fields.get("aws_session_token") or None,
                              f"profile {name}")
    return None


def _encode(text: str) -> str:
    """SigV4's URI encoding: all but the unreserved characters."""
    return urllib.parse.quote(text, safe="-_.~")


def canonical_query(query: str) -> str:
    """A query string sorted and encoded as SigV4 signs it (empty values
    kept); S3 requests send it in this form too."""
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    return "&".join(f"{_encode(k)}={_encode(v)}" for k, v in sorted(pairs))


def amz_date(when: datetime.datetime) -> str:
    return when.astimezone(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")


def sign_s3(method: str, path: str, query: str, headers: Dict[str, str],
            payload_sha256: str, credentials: AwsCredentials, region: str,
            when: datetime.datetime) -> str:
    """The ``Authorization`` value of an S3 request: AWS SigV4 over
    ``method``, the URI-encoded ``path`` as sent (S3 encodes a key once),
    the sorted ``query``, every header of ``headers`` (lower-cased, sorted,
    values trimmed) and the body's SHA-256, at time ``when``."""
    stamp = amz_date(when)
    canon = {k.strip().lower(): " ".join(str(v).split())
             for k, v in headers.items()}
    names = sorted(canon)
    request = "\n".join([
        method, path, canonical_query(query),
        "".join(f"{n}:{canon[n]}\n" for n in names), ";".join(names),
        payload_sha256])
    scope = f"{stamp[:8]}/{region}/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", stamp, scope,
                         hashlib.sha256(request.encode()).hexdigest()])
    key = ("AWS4" + credentials.secret_key).encode()
    for part in (stamp[:8], region, "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    signature = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    return (f"AWS4-HMAC-SHA256 Credential={credentials.access_key}/{scope}, "
            f"SignedHeaders={';'.join(names)}, Signature={signature}")


def s3_headers(method: str, host: str, path: str, query: str,
               headers: Dict[str, str], payload_sha256: str,
               credentials: Optional[AwsCredentials], region: str,
               when: Optional[datetime.datetime] = None) -> Dict[str, str]:
    """The headers of one S3 request as tensorstore sends them: ``headers``,
    ``host`` (with its port where it is not the scheme's),
    ``x-amz-content-sha256`` and ``x-amz-date``, and with credentials
    ``x-amz-security-token`` for a session, all of them signed into
    ``authorization``; without credentials, no signature."""
    when = when or datetime.datetime.now(datetime.timezone.utc)
    out = {"host": host, **headers, "x-amz-content-sha256": payload_sha256,
           "x-amz-date": amz_date(when)}
    if credentials is None:
        return out
    if credentials.session_token:
        out["x-amz-security-token"] = credentials.session_token
    out["authorization"] = sign_s3(method, path, query, out, payload_sha256,
                                   credentials, region, when)
    return out


# ------------------------------------------------------------------ RSA

def _der(data: bytes, i: int) -> Tuple[int, int, int]:
    """(tag, start, end) of the DER element at ``i``."""
    tag, n = data[i], data[i + 1]
    i += 2
    if n & 0x80:
        k = n & 0x7F
        n = int.from_bytes(data[i:i + k], "big")
        i += k
    return tag, i, i + n


def _children(data: bytes, start: int, end: int):
    out = []
    while start < end:
        tag, s, e = _der(data, start)
        out.append((tag, s, e))
        start = e
    return out


def rsa_private_key(pem: str) -> Tuple[int, ...]:
    """(n, e, d, p, q, dp, dq, qinv) of an RSA key in PEM: PKCS#8
    (``BEGIN PRIVATE KEY``) or PKCS#1 (``BEGIN RSA PRIVATE KEY``)."""
    body = "".join(line for line in pem.strip().splitlines()
                   if line and not line.startswith("-----"))
    der = base64.b64decode(body)
    tag, s, e = _der(der, 0)
    parts = _children(der, s, e)
    if len(parts) >= 3 and parts[1][0] == 0x30 and parts[2][0] == 0x04:
        _, s, e = parts[2]                         # PKCS#8 -> PKCS#1
        tag, s, e = _der(der, s)
        parts = _children(der, s, e)
    ints = [int.from_bytes(der[s:e], "big") for t, s, e in parts if t == 0x02]
    if tag != 0x30 or len(ints) < 9:
        raise ValueError("not an RSA private key (PKCS#1 or PKCS#8 PEM)")
    return tuple(ints[1:9])


# DigestInfo of SHA-256 (RFC 8017, 9.2 note 1)
_SHA256_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def rs256_sign(pem: str, message: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 with SHA-256 (RS256), by ``pow`` and the CRT."""
    n, _, _, p, q, dp, dq, qinv = rsa_private_key(pem)
    k = (n.bit_length() + 7) // 8
    info = _SHA256_INFO + hashlib.sha256(message).digest()
    m = int.from_bytes(b"\x00\x01" + b"\xff" * (k - len(info) - 3) + b"\x00"
                       + info, "big")
    m1, m2 = pow(m, dp, p), pow(m, dq, q)
    s = m2 + (qinv * (m1 - m2) % p) * q
    return s.to_bytes(k, "big")


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _json(obj) -> str:
    return json.dumps(obj, separators=(",", ":"), sort_keys=True,
                      ensure_ascii=False)


def service_account_jwt(info: Dict[str, str], now: int) -> str:
    """The signed JWT of tensorstore's service-account grant: header
    ``alg``/``kid``/``typ``, claims ``aud``/``exp``/``iat``/``iss``/
    ``scope`` (keys sorted, as its JSON writer orders them)."""
    header = _json({"alg": "RS256", "kid": info.get("private_key_id", ""),
                    "typ": "JWT"})
    claims = _json({"aud": GOOGLE_TOKEN_AUDIENCE, "exp": now + JWT_LIFETIME_S,
                    "iat": now, "iss": info["client_email"],
                    "scope": GCS_SCOPE})
    head = f"{_b64url(header.encode())}.{_b64url(claims.encode())}"
    return f"{head}.{_b64url(rs256_sign(info['private_key'], head.encode()))}"


# ------------------------------------------------------------------ GCS

def request_once(method: str, url: str, body: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 timeout: float = 30):
    """(status, response headers, body) of one request on a new
    connection."""
    parts = urllib.parse.urlsplit(url)
    cls = (http.client.HTTPSConnection if parts.scheme == "https"
           else http.client.HTTPConnection)
    conn = cls(parts.hostname, parts.port, timeout=timeout)
    try:
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        conn.request(method, target, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


class _Provider:
    """A source of bearer tokens; ``header()`` refreshes one that is within
    TOKEN_MARGIN_S of its end."""

    def __init__(self, kind: str):
        self.kind = kind
        self.lock = threading.Lock()
        self.token: Optional[str] = None
        self.expires = 0.0

    def header(self) -> str:
        with self.lock:
            if self.token is None or time.time() >= self.expires:
                token, lifetime = self.fetch()
                self.token = token
                self.expires = time.time() + lifetime - TOKEN_MARGIN_S
            return f"Bearer {self.token}"

    def fetch(self) -> Tuple[str, float]:
        raise NotImplementedError

    def _grant(self, url: str, body: str, headers=None) -> Tuple[str, float]:
        method = "POST" if body else "GET"
        hdrs = dict(headers or {})
        if body:
            hdrs["Content-Type"] = "application/x-www-form-urlencoded"
        try:
            status, _, data = request_once(method, url,
                                           body.encode() or None, hdrs)
        except OSError as exc:
            raise OSError(f"{method} {url} ({self.kind} token): "
                          f"{type(exc).__name__}") from None
        if status != 200:
            raise OSError(f"{method} {url} ({self.kind} token): HTTP {status}")
        try:
            got = json.loads(data)
            return str(got["access_token"]), float(got["expires_in"])
        except (ValueError, KeyError, TypeError):
            raise OSError(f"{method} {url} ({self.kind} token): no "
                          "access_token / expires_in in the answer") from None


class _Fixed(_Provider):
    def __init__(self, token: str):
        super().__init__("fixed")
        self.token, self.expires = token, float("inf")


class _ServiceAccount(_Provider):
    def __init__(self, info):
        super().__init__("service_account")
        self.info = info

    def fetch(self):
        jwt = service_account_jwt(self.info, int(time.time()))
        return self._grant(GOOGLE_TOKEN_URL,
                           f"grant_type={_JWT_GRANT}&assertion={jwt}")


class _AuthorizedUser(_Provider):
    def __init__(self, info):
        super().__init__("authorized_user")
        self.info = info

    def fetch(self):
        i = self.info
        return self._grant(GOOGLE_TOKEN_URL, (
            f"client_id={i['client_id']}&client_secret={i['client_secret']}"
            f"&refresh_token={i['refresh_token']}&grant_type=refresh_token"))


class _Metadata(_Provider):
    def __init__(self, host: str):
        super().__init__("metadata server")
        self.host = host

    def fetch(self):
        return self._grant(
            f"http://{self.host}/computeMetadata/v1/instance/"
            "service-accounts/default/token", "",
            {"Metadata-Flavor": "Google"})


def _key_file(path: str) -> _Provider:
    try:
        with open(path, encoding="utf-8") as f:
            info = json.load(f)
    except (OSError, ValueError) as exc:
        raise OSError(f"Google credentials file {path}: unreadable "
                      f"({type(exc).__name__})") from None
    kind = info.get("type")
    if kind == "authorized_user" or (kind is None and "refresh_token" in info):
        return _AuthorizedUser(info)
    if kind == "service_account":
        return _ServiceAccount(info)
    raise OSError(f"Google credentials file {path}: type {kind!r} is not "
                  "service_account or authorized_user")


def _on_metadata_server(host: str) -> bool:
    try:
        _, headers, _ = request_once("GET", f"http://{host}/", None,
                                     {"Metadata-Flavor": "Google"},
                                     timeout=2)
    except OSError:
        return False
    return headers.get("Metadata-Flavor") == "Google"


_providers: Dict[tuple, Optional[_Provider]] = {}
_providers_lock = threading.Lock()


def _gcs_provider(env) -> Optional[_Provider]:
    fixed = env.get("GOOGLE_AUTH_TOKEN_FOR_TESTING")
    if fixed:
        return _Fixed(fixed)
    path = env.get("GOOGLE_APPLICATION_CREDENTIALS")
    if path:
        return _key_file(path)
    home = env.get("HOME") or os.path.expanduser("~")
    gcloud = env.get("CLOUDSDK_CONFIG") or os.path.join(home, ".config",
                                                       "gcloud")
    well_known = os.path.join(gcloud, "application_default_credentials.json")
    if os.path.isfile(well_known):
        return _key_file(well_known)
    host = env.get("GCE_METADATA_ROOT") or GCE_METADATA_HOST
    return _Metadata(host) if _on_metadata_server(host) else None


def gcs_authorization() -> Optional[str]:
    """The ``Authorization`` value of a GCS request (``Bearer ...``), or
    None (anonymous). The source is chosen once per environment and kept,
    with its token."""
    env = os.environ
    key = tuple(env.get(k) for k in (
        "GOOGLE_AUTH_TOKEN_FOR_TESTING", "GOOGLE_APPLICATION_CREDENTIALS",
        "CLOUDSDK_CONFIG", "HOME", "GCE_METADATA_ROOT")) + (
        GOOGLE_TOKEN_URL, GCE_METADATA_HOST)
    with _providers_lock:
        if key not in _providers:
            _providers[key] = _gcs_provider(env)
        provider = _providers[key]
    return None if provider is None else provider.header()
