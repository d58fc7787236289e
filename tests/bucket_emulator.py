"""An S3 + GCS emulator on 127.0.0.1, standard library only, for the
private-bucket stores of the port (``data/zio.py``'s ``_S3KV`` /
``_GcsKV``) and the JAX package's tensorstore ``s3`` / ``gcs`` drivers.

* S3, path style (``/{bucket}/{key}``): ``HEAD /{bucket}`` answers the
  region (``x-amz-bucket-region``) unsigned; object ``GET`` / ``HEAD`` /
  ``PUT`` / ``DELETE`` with ``If-Match`` and ``If-None-Match: *``;
  ListObjectsV2 with continuation tokens. A signed request must verify
  (:func:`sigv4_ok`, written from AWS's rules, sharing no code with the
  port) against ``secrets``, else 403.
* GCS, JSON API: media ``GET`` (``x-goog-generation``), media upload
  with ``ifGenerationMatch``, the object list (``prefix`` or
  tensorstore's ``startOffset`` / ``endOffset``) with page tokens,
  ``DELETE``.
* ``POST /token``: an OAuth2 endpoint; a JWT-bearer grant must verify
  (:func:`jwt_claims_ok`) where a public key is given; refresh-token
  grants are recorded. ``GET /`` answers as a host that is not a metadata
  server. ``GET /_stats`` gives the counts.

An s3 and a gs bucket of one name are two buckets. Lists are paged at
``page`` keys; a conditional write whose condition fails answers 412.
With ``strict``, an unsigned S3 request (but the region's ``HEAD``) gets
403 and a GCS request without a bearer token this emulator issued 401.
In a bucket named ``slow-...``, the first two reads of an object meet:
the first is answered only when the second has taken its own snapshot
(or after ``meet_s``), so two writers that read-modify-write one object
both read the same version and one of their conditional writes is
overtaken every time. ``fail`` holds statuses to answer the next
requests with, ``deny`` answers 403 to every signed request. Every
request is recorded (``records``), without its body.

    python tests/bucket_emulator.py CONF.json

runs one in this process until terminated, after printing ``PORT n``
(``CONF``: ``aws`` {key: secret}, ``jwt_n`` (hex), ``jwt_e``,
``jwt_iss``, ``strict``, ``page``, ``meet_s``).
"""

import base64
import collections
import hashlib
import hmac
import http.server
import json
import re
import secrets as _secrets
import sys
import threading
import urllib.parse
from xml.sax.saxutils import escape

JWT_AUDIENCE = "https://www.googleapis.com/oauth2/v3/token"
JWT_SCOPE = "https://www.googleapis.com/auth/cloud-platform"
REGION = "eu-west-2"
_SHA256_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def sigv4_ok(method, target, headers, body_sha256, secrets) -> bool:
    """Whether an S3 request's ``authorization`` (``headers`` lower-cased)
    is AWS SigV4 over its method, path, query, signed headers and body
    (``body_sha256``) with the secret of its access key in ``secrets``."""
    m = re.fullmatch(
        r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/([a-z0-9-]+)/s3/"
        r"aws4_request, SignedHeaders=([a-z0-9;-]+), "
        r"Signature=([0-9a-f]{64})", headers.get("authorization", ""))
    if m is None or m.group(1) not in secrets:
        return False
    key, day, region, signed, signature = m.groups()
    names = signed.split(";")
    stamp = headers.get("x-amz-date", "")
    if (headers.get("x-amz-content-sha256") != body_sha256
            or not stamp.startswith(day) or names != sorted(names)
            or not {"host", "x-amz-date", "x-amz-content-sha256"} <= set(
                names)):
        return False
    path, _, query = target.partition("?")
    enc = lambda s: urllib.parse.quote(urllib.parse.unquote(s), safe="-_.~")
    pairs = sorted((enc(k), enc(v)) for k, _, v in (
        p.partition("=") for p in query.split("&") if p))
    canonical = "\n".join([
        method, path, "&".join(f"{k}={v}" for k, v in pairs),
        "".join(f"{n}:{' '.join(headers.get(n, '').split())}\n"
                for n in names), signed, body_sha256])
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", stamp, f"{day}/{region}/s3/aws4_request",
        hashlib.sha256(canonical.encode()).hexdigest()])
    k = ("AWS4" + secrets[key]).encode()
    for part in (day, region, "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return hmac.compare_digest(
        hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest(), signature)


def _b64(s):
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_claims_ok(assertion, n, e, issuer):
    """(header, claims) of a JWT-bearer assertion whose RS256 signature
    verifies against the public key (n, e) (the whole EMSA-PKCS1-v1_5
    block compared) and whose claims are the grant's (``iss``, ``aud``,
    ``scope``, an hour from ``iat`` to ``exp``), else None."""
    try:
        head, body, sig = assertion.split(".")
        header, claims = json.loads(_b64(head)), json.loads(_b64(body))
        k = (n.bit_length() + 7) // 8
        want = (b"\x00\x01" + b"\xff" * (k - 54) + b"\x00" + _SHA256_INFO
                + hashlib.sha256(f"{head}.{body}".encode()).digest())
        got = pow(int.from_bytes(_b64(sig), "big"), e, n).to_bytes(k, "big")
    except (ValueError, TypeError, OverflowError):
        return None
    ok = (got == want and header.get("alg") == "RS256"
          and claims.get("iss") == issuer and claims.get("aud") == JWT_AUDIENCE
          and claims.get("scope") == JWT_SCOPE
          and claims.get("exp", 0) - claims.get("iat", 0) == 3600)
    return (header, claims) if ok else None


class BucketEmulator:
    """The emulator on a free port of 127.0.0.1, served by a thread of
    this process; ``url`` its base, ``close()`` stops it."""

    def __init__(self, secrets=None, jwt=None, strict=False, page=2,
                 meet_s=30.0):
        self.secrets = dict(secrets or {})
        self.jwt = jwt                  # (n, e, issuer) or None
        self.strict, self.page, self.meet_s = strict, page, meet_s
        self.meets = {}                 # (bucket, key) -> [reads, Event]
        self.objects = {}               # (bucket, key) -> (bytes, gen, etag)
        self.records = []
        self.stats = collections.Counter()
        self.lock = threading.Lock()
        self.generation = 0
        self.fail = []
        self.deny = False
        self.grants = []
        self.issued = set()
        self.expires_in = 3600
        emu = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def handle_any(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                status, out, hdrs = emu.serve(self.command, self.path,
                                              self.headers, body)
                self.send_response(status)
                for k, v in hdrs:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                if self.command != "HEAD" and out:
                    self.wfile.write(out)

            do_GET = do_PUT = do_HEAD = do_DELETE = do_POST = handle_any

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)

    # -- what the tests read
    def keys(self, scheme, bucket, prefix=""):
        with self.lock:
            return sorted(k for b, k in self.objects
                          if b == f"{scheme}:{bucket}"
                          and k.startswith(prefix))

    def get(self, scheme, bucket, key):
        return self.objects[(f"{scheme}:{bucket}", key)][0]

    def since(self, mark):
        return self.records[mark:]

    # -- the protocol
    def serve(self, method, target, raw_headers, body):
        headers = {k.lower(): v for k, v in raw_headers.items()}
        parts = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(parts.query,
                                            keep_blank_values=True))
        sha = hashlib.sha256(body).hexdigest()
        record = {"method": method, "target": target, "headers": headers,
                  "body_sha256": sha}
        with self.lock:
            self.records.append(record)
            self.stats["requests"] += 1
            forced = self.fail.pop(0) if self.fail else None
        status, out, hdrs = self._route(method, target, parts.path, query,
                                        headers, body, sha, forced)
        record["status"] = status
        with self.lock:
            self.stats[status] += 1
        return status, out, hdrs

    def _route(self, method, target, path, query, headers, body, sha,
               forced):
        if forced is not None:
            return forced, b"", ()
        if self.deny and "authorization" in headers:
            return 403, b"<Error><Code>AccessDenied</Code></Error>", ()
        if path == "/_stats":
            with self.lock:
                return 200, json.dumps(self.stats).encode(), ()
        if path == "/token":
            return self._token(body)
        if path == "/":
            return 200, b"not a metadata server", ()
        if path.startswith(("/storage/v1/", "/upload/storage/v1/")):
            auth = headers.get("authorization", "")
            if self.strict and not (auth.startswith("Bearer ")
                                    and auth[7:] in self.issued):
                self._count("refused")
                return 401, b"", ()
            return self._gcs(method, path, query, body)
        bucket, _, key = path.lstrip("/").partition("/")
        if not key and method == "HEAD":
            return 200, b"", [("x-amz-bucket-region", REGION)]
        signed = "authorization" in headers
        if (signed or self.strict) and not sigv4_ok(
                method, target, headers, sha, self.secrets):
            self._count("refused")
            return 403, b"<Error><Code>AccessDenied</Code></Error>", ()
        return self._s3(method, f"s3:{bucket}", urllib.parse.unquote(key),
                        query, headers, body)

    def _count(self, name):
        with self.lock:
            self.stats[name] += 1

    def _put(self, bucket, key, body):
        self.generation += 1
        self.objects[(bucket, key)] = (
            body, self.generation, f'"{hashlib.md5(body).hexdigest()}"')

    def _list(self, bucket, keys, start):
        keys = [k for k in keys if not start or k > start]
        page = keys[:self.page]
        return page, (page[-1] if len(keys) > self.page else None)

    def _met(self, bucket, key, answer):
        """``answer`` (a read's, snapshotted) once the object's first two
        reads in a ``slow-`` bucket have both snapshotted."""
        if bucket.split(":", 1)[1].startswith("slow-"):
            with self.lock:
                meet = self.meets.setdefault((bucket, key),
                                             [0, threading.Event()])
                meet[0] += 1
                n = meet[0]
            if n == 1:
                meet[1].wait(self.meet_s)
            elif n == 2:
                meet[1].set()
        return answer

    def _s3(self, method, bucket, key, query, headers, body):
        if not key and method == "GET":
            page, token = self._list(bucket, sorted(
                k for b, k in list(self.objects) if b == bucket
                and k.startswith(query.get("prefix", ""))),
                query.get("continuation-token"))
            xml = ['<?xml version="1.0" encoding="UTF-8"?><ListBucketResult '
                   'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                   f"<KeyCount>{len(page)}</KeyCount><IsTruncated>"
                   f"{'true' if token else 'false'}</IsTruncated>"]
            xml += [f"<Contents><Key>{escape(k)}</Key></Contents>"
                    for k in page]
            if token:
                xml.append(f"<NextContinuationToken>{escape(token)}"
                           "</NextContinuationToken>")
            xml.append("</ListBucketResult>")
            return 200, "".join(xml).encode(), [("Content-Type",
                                                 "application/xml")]
        with self.lock:
            have = self.objects.get((bucket, key))
            missing = have is None and method in ("GET", "HEAD")
            match = headers.get("if-match")
            if not missing and (
                    (match is not None and (have is None or match != have[2]))
                    or (headers.get("if-none-match") == "*"
                        and have is not None)):
                self.stats["conflicts"] += 1
                return 412, b"", ()
            if method == "PUT":
                self._put(bucket, key, body)
                return 200, b"", [("ETag", self.objects[(bucket, key)][2])]
            if method == "DELETE":
                self.objects.pop((bucket, key), None)
                return 204, b"", ()
            if method not in ("GET", "HEAD"):
                return 400, b"", ()
        return self._met(bucket, key, (
            404, b"<Error><Code>NoSuchKey</Code></Error>", ()) if missing
            else (200, have[0], [("ETag", have[2])]))

    def _gcs(self, method, path, query, body):
        seg = path.split("/")
        if path.startswith("/upload/"):
            bucket, key = f"gs:{seg[5]}", query.get("name", "")
            with self.lock:
                have = self.objects.get((bucket, key))
                if "ifGenerationMatch" in query and int(
                        query["ifGenerationMatch"]) != (have[1] if have
                                                        else 0):
                    self.stats["conflicts"] += 1
                    return 412, b"", ()
                self._put(bucket, key, body)
                gen = self.generation
            return 200, json.dumps({"name": key, "generation": str(gen)}
                                   ).encode(), ()
        bucket = f"gs:{seg[4]}"
        if len(seg) == 6 or seg[6] == "":
            names = sorted(k for b, k in list(self.objects) if b == bucket)
            if "startOffset" in query:      # tensorstore's range list
                lo, hi = query["startOffset"], query.get("endOffset")
                names = [k for k in names if lo <= k and (hi is None
                                                          or k < hi)]
            else:
                names = [k for k in names
                         if k.startswith(query.get("prefix", ""))]
            page, token = self._list(bucket, names, query.get("pageToken"))
            out = {"items": [{"name": k} for k in page]}
            if token:
                out["nextPageToken"] = token
            return 200, json.dumps(out).encode(), ()
        key = urllib.parse.unquote(seg[6])
        with self.lock:
            have = self.objects.get((bucket, key))
            if method == "DELETE":
                if have is None:
                    return 404, b"", ()
                del self.objects[(bucket, key)]
                return 204, b"", ()
            if method != "GET":
                return 400, b"", ()
        return self._met(bucket, key, (
            404, b'{"error": {"code": 404}}', ()) if have is None
            else (200, have[0], [("x-goog-generation", str(have[1]))]))

    def _token(self, body):
        form = dict(urllib.parse.parse_qsl(body.decode()))
        grant = form.get("grant_type", "")
        if grant.endswith("jwt-bearer"):
            parts = form.get("assertion", "").split(".")
            if self.jwt is not None:
                got = jwt_claims_ok(form.get("assertion", ""), *self.jwt)
            elif len(parts) == 3:
                got = json.loads(_b64(parts[0])), json.loads(_b64(parts[1]))
            else:
                got = None
            if got is None:
                self._count("refused_grants")
                return 401, b'{"error": "invalid_grant"}', ()
            self.grants.append(("jwt",) + got)
        elif grant == "refresh_token":
            self.grants.append(("refresh", form, None))
        else:
            return 400, b'{"error": "unsupported_grant_type"}', ()
        self._count("grants")
        token = f"issued-{len(self.grants)}-{_secrets.token_hex(8)}"
        with self.lock:
            self.issued.add(token)
        return 200, json.dumps({"access_token": token, "token_type": "Bearer",
                                "expires_in": self.expires_in}).encode(), ()


def main(conf_path) -> int:
    with open(conf_path, encoding="utf-8") as f:
        conf = json.load(f)
    emu = BucketEmulator(
        secrets=conf.get("aws"), strict=conf.get("strict", False),
        jwt=(int(conf["jwt_n"], 16), int(conf["jwt_e"]), conf["jwt_iss"])
        if "jwt_n" in conf else None,
        page=conf.get("page", 2), meet_s=conf.get("meet_s", 30.0))
    print(f"PORT {emu.url.rsplit(':', 1)[1]}", flush=True)
    emu.thread.join()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
