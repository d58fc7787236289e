"""The port's private-bucket stores (``data/zio.py``'s ``_S3KV`` and
``_GcsKV``, ``data/remote_auth.py``'s signatures and tokens) against the
JAX package's tensorstore ``s3`` and ``gcs`` kvstores, on the CPU, over a
stdlib S3 + GCS emulator on 127.0.0.1 in the test process (no outside
network). The JAX package runs unmodified: the test wraps its
``_kvstore_spec`` to add tensorstore's ``endpoint`` for s3, and points gcs
at the emulator with ``TENSORSTORE_GCS_HTTP_URL`` and
``GOOGLE_AUTH_TOKEN_FOR_TESTING``; the port is pointed there by
monkeypatching ``zio.s3_endpoint`` and ``remote_auth.GOOGLE_TOKEN_URL``.

* (a) every request tensorstore signed (GET, HEAD, PUT of ``.zarray`` and
  of a chunk, ListObjectsV2, DELETE), with environment, session and
  profile credentials: the port's ``sign_s3`` given its method, path,
  query, signed headers, body hash and time gives its ``Authorization``
  byte for byte, and the port's own requests sign the same header sets;
* (b) u8 / u16 / f32 arrays, Blosc zstd-5 bit shuffle and uncompressed,
  on s3 and gs: JAX-written and port-written arrays have the same object
  keys and ``.zarray`` bytes, the uncompressed chunks the same bytes (the
  Blosc ones the same values: the port's zstd encoder is not libzstd), and
  each side reads the other's;
* (c) both ``zarr_crop`` tools bucket to bucket, over an existing array:
  the same objects, the same keys deleted;
* (d) two processes writing disjoint halves of one chunk, 20 rounds, on
  s3 and gs: both halves survive and the emulator answered 412s;
* (e) without credentials every request is unsigned, as tensorstore's;
* (f) RS256 against ``cryptography`` (test side only), the service-account
  and refresh-token grants against the emulator's token endpoint, cached;
* (g) no error carries a secret, a token or a signature, and a refused
  signed request raises without an anonymous retry;
* the golden requests of ``tests/data/remote_auth/`` (tensorstore's,
  recorded by ``tests/make_remote_auth_fixtures.py``) replayed through the
  port's signer with tensorstore unused, as ``chip_smoke.py`` phase 22a
  replays them on the card.
"""

import base64
import datetime
import json
import os
import subprocess
import sys
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from bucket_emulator import BucketEmulator
from mt3d_resenc_unet_torch.data import remote_auth
from mt3d_resenc_unet_torch.data import zio as tzio

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "remote_auth"
REGION = "eu-west-2"
# AWS's published example credentials (SigV4 test suite)
EXAMPLE_KEY = "AKIDEXAMPLE"
EXAMPLE_SECRET = "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
SESSION = "FQoGZXIvYXdzEXAMPLE//session+token/="
TS_TOKEN = "tensorstore-fixed-token"
SHAPE, CHUNKS = (12, 20, 18), (8, 8, 8)


@pytest.fixture(scope="module")
def emu():
    """The emulator (``tests/bucket_emulator.py``) in this process: S3
    requests signed with the example key must verify, unsigned ones pass
    (as to a public bucket); any bearer token passes; lists paged at 2
    keys, so the continuation path always runs."""
    e = BucketEmulator(secrets={EXAMPLE_KEY: EXAMPLE_SECRET}, page=2)
    yield e
    e.close()


# ------------------------------------------------------------ the JAX side

@pytest.fixture(scope="module")
def jzio():
    return pytest.importorskip("mt3d_resenc_unet_tpu.data.zio")


_CONTEXT = {}     # a tensorstore context for the kvstore spec, per test


@pytest.fixture(autouse=True)
def isolated(emu, jzio, monkeypatch, tmp_path):
    """Credentials only from what a test sets; every store on the
    emulator."""
    for name in list(os.environ):
        if name.startswith(("AWS_", "GOOGLE_", "GCE_", "CLOUDSDK_")):
            monkeypatch.delenv(name)
    (tmp_path / "aws_config").write_text("")
    (tmp_path / "aws_credentials").write_text("")
    (tmp_path / "gcloud").mkdir()
    monkeypatch.setenv("AWS_EC2_METADATA_DISABLED", "true")
    monkeypatch.setenv("AWS_CONFIG_FILE", str(tmp_path / "aws_config"))
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE",
                       str(tmp_path / "aws_credentials"))
    monkeypatch.setenv("CLOUDSDK_CONFIG", str(tmp_path / "gcloud"))
    monkeypatch.setenv("GCE_METADATA_ROOT", emu.url[len("http://"):])
    monkeypatch.setenv("TENSORSTORE_GCS_HTTP_URL", emu.url)
    monkeypatch.setattr(tzio, "s3_endpoint",
                        lambda bucket, region=None: f"{emu.url}/{bucket}")
    monkeypatch.setattr(remote_auth, "GOOGLE_TOKEN_URL", f"{emu.url}/token")
    monkeypatch.setattr(remote_auth, "_providers", {})
    original = jzio._kvstore_spec

    def spec(path):
        out = original(path)
        if out["driver"] == "s3":
            out["endpoint"] = emu.url
            out.update(_CONTEXT)
        return out

    monkeypatch.setattr(jzio, "_kvstore_spec", spec)
    _CONTEXT.clear()
    emu.fail, emu.deny, emu.jwt, emu.expires_in = [], False, None, 3600
    yield tmp_path
    _CONTEXT.clear()


def env_credentials(monkeypatch, session=False):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", EXAMPLE_KEY)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", EXAMPLE_SECRET)
    if session:
        monkeypatch.setenv("AWS_SESSION_TOKEN", SESSION)
    return remote_auth.AwsCredentials(EXAMPLE_KEY, EXAMPLE_SECRET,
                                      SESSION if session else None)


def profile_credentials(monkeypatch, tmp):
    """The profile ``dev`` of the shared credentials file (its region in
    the config file). tensorstore 0.1.80's default chain does not load a
    profile here (it logs "could not load a profile at ."), so its side
    reads the same files through its ``profile`` credential type."""
    (tmp / "aws_credentials").write_text(
        f"[dev]\naws_access_key_id = {EXAMPLE_KEY}\n"
        f"aws_secret_access_key = {EXAMPLE_SECRET}\n"
        f"aws_session_token = {SESSION}\n")
    (tmp / "aws_config").write_text(f"[profile dev]\nregion = {REGION}\n")
    monkeypatch.setenv("AWS_PROFILE", "dev")
    _CONTEXT["context"] = {"aws_credentials": {
        "type": "profile", "profile": "dev",
        "credentials_file": str(tmp / "aws_credentials"),
        "config_file": str(tmp / "aws_config")}}
    return remote_auth.AwsCredentials(EXAMPLE_KEY, EXAMPLE_SECRET, SESSION,
                                      "profile dev")


def test_credential_sources_in_order(isolated, monkeypatch):
    """The environment before the profile; the profile's keys from the
    credentials file over the config file's; ``default`` without
    ``AWS_PROFILE``; none -> None."""
    cfg, cred = isolated / "aws_config", isolated / "aws_credentials"
    assert remote_auth.aws_credentials() is None
    cfg.write_text("[default]\naws_access_key_id = CFGDEFAULT\n"
                   "aws_secret_access_key = s0\n"
                   "[profile dev]\naws_access_key_id = CFGDEV\n"
                   "aws_secret_access_key = s1\naws_session_token = t1\n")
    got = remote_auth.aws_credentials()
    assert (got.access_key, got.source) == ("CFGDEFAULT", "profile default")
    monkeypatch.setenv("AWS_PROFILE", "dev")
    got = remote_auth.aws_credentials()
    assert (got.access_key, got.secret_key, got.session_token) == (
        "CFGDEV", "s1", "t1")
    cred.write_text("[dev]\naws_access_key_id = CREDDEV\n"
                    "aws_secret_access_key = s2\n")
    got = remote_auth.aws_credentials()
    assert (got.access_key, got.secret_key, got.session_token) == (
        "CREDDEV", "s2", "t1")
    assert "s2" not in repr(got) and "t1" not in repr(got)
    env_credentials(monkeypatch)
    assert remote_auth.aws_credentials().source == "environment"
    monkeypatch.setenv("HOME", str(isolated))
    monkeypatch.delenv("AWS_ACCESS_KEY_ID")
    monkeypatch.delenv("AWS_SHARED_CREDENTIALS_FILE")
    monkeypatch.delenv("AWS_CONFIG_FILE")
    (isolated / ".aws").mkdir()
    (isolated / ".aws" / "credentials").write_text(
        "[dev]\naws_access_key_id = HOMEDEV\naws_secret_access_key = s3\n")
    assert remote_auth.aws_credentials().access_key == "HOMEDEV"


def _volume(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(SHAPE).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, SHAPE, dtype=dtype)


def _write(zio, path, data, **kw):
    """Whole chunks, partial chunks over them, and chunks never written."""
    vol = zio.create_zarr(path, SHAPE, data.dtype, CHUNKS, **kw)
    vol[0:8, 0:16] = data[0:8, 0:16]
    vol[2:10, 5:12, 3:11] = data[2:10, 5:12, 3:11]
    want = np.zeros(SHAPE, data.dtype)
    want[0:8, 0:16] = data[0:8, 0:16]
    want[2:10, 5:12, 3:11] = data[2:10, 5:12, 3:11]
    return want


# ------------------------------------------------------------ (a) SigV4

def _parse_auth(value):
    scheme, rest = value.split(" ", 1)
    fields = dict(p.strip().split("=", 1) for p in rest.split(","))
    _, date, region, service, _ = fields["Credential"].split("/")
    return fields["SignedHeaders"].split(";"), region, service


def _when(stamp):
    return datetime.datetime.strptime(stamp, "%Y%m%dT%H%M%SZ").replace(
        tzinfo=datetime.timezone.utc)


def replay(record, credentials):
    """The port's Authorization for a recorded request."""
    headers = record["headers"]
    names, region, _ = _parse_auth(headers["authorization"])
    path, _, query = record["target"].partition("?")
    return remote_auth.sign_s3(
        record["method"], path, query, {n: headers[n] for n in names},
        headers["x-amz-content-sha256"], credentials, region,
        _when(headers["x-amz-date"]))


def _kind(record):
    """What a recorded S3 request does."""
    method, target = record["method"], record["target"]
    if "list-type=2" in target:
        return "list"
    if method == "PUT":
        return "PUT .zarray" if target.endswith(".zarray") else "PUT chunk"
    return method


def _signed_set(record):
    names = _parse_auth(record["headers"]["authorization"])[0]
    return ";".join(n for n in names if n not in ("if-none-match",
                                                  "if-match"))


def _s3_session(zio, name, data):
    """The requests of one round trip: create, partial writes, read,
    recreate with delete_existing."""
    _write(zio, f"s3://{name}/vol.zarr", data)
    np.asarray(zio.open_zarr(f"s3://{name}/vol.zarr")[...])
    zio.create_zarr(f"s3://{name}/vol.zarr", SHAPE, data.dtype, CHUNKS,
                    delete_existing=True)


@pytest.mark.parametrize("source", ["env", "session", "profile"])
def test_sigv4_equals_tensorstore(emu, jzio, isolated, monkeypatch, source):
    if source == "profile":
        creds = profile_credentials(monkeypatch, isolated)
    else:
        creds = env_credentials(monkeypatch, session=source == "session")
    assert remote_auth.aws_credentials() == creds
    data = _volume(np.uint8)
    mark = len(emu.records)
    _s3_session(jzio, f"ts-{source}", data)
    theirs = [r for r in emu.since(mark) if "authorization" in r["headers"]]
    kinds = {_kind(r) for r in theirs}
    assert {"GET", "HEAD", "PUT .zarray", "PUT chunk", "list",
            "DELETE"} <= kinds
    for r in theirs:
        assert r["headers"]["authorization"].startswith(
            f"AWS4-HMAC-SHA256 Credential={EXAMPLE_KEY}/")
        assert replay(r, creds) == r["headers"]["authorization"], r["target"]
        assert (r["headers"].get("x-amz-security-token") == SESSION) == (
            creds.session_token is not None)
        assert r["headers"]["x-amz-content-sha256"] == r["body_sha256"]
    # the port's own requests sign the header sets tensorstore signs
    mark = len(emu.records)
    _s3_session(tzio, f"port-{source}", data)
    mine = [r for r in emu.since(mark) if r["method"] != "HEAD"
            or r["target"].count("/") > 1]
    assert mine and all("authorization" in r["headers"] for r in mine)
    for r in mine:
        assert replay(r, creds) == r["headers"]["authorization"]
    sets = {}
    for side in (theirs, mine):
        for r in side:
            sets.setdefault(_kind(r), set()).add(_signed_set(r))
    for kind in ("GET", "PUT .zarray", "PUT chunk", "list", "DELETE"):
        assert len(sets[kind]) == 1, (kind, sets[kind])
    zarray_put = [r for r in mine if _kind(r) == "PUT .zarray"]
    assert all(r["headers"]["if-none-match"] == "*" for r in zarray_put)


# ------------------------------------------------------------ (b) arrays

def _objects(emu, scheme, bucket, prefix):
    return {k[len(prefix):]: emu.get(scheme, bucket, k)
            for k in emu.keys(scheme, bucket, prefix)}


def _decoded(emu, scheme, bucket, prefix, dtype, compressor):
    from mt3d_resenc_unet_torch.data import codec
    out = {}
    for k, v in _objects(emu, scheme, bucket, prefix).items():
        if k == ".zarray":
            out[k] = v
        else:
            chunk = np.empty(CHUNKS, dtype)
            codec.decode_chunk_into(compressor, v, chunk)
            out[k] = chunk.tobytes()
    return out


@pytest.mark.parametrize("scheme", ["s3", "gs"])
@pytest.mark.parametrize("compressor", [tzio.DEFAULT_COMPRESSOR, None],
                         ids=["blosc_zstd", "none"])
def test_arrays_equal_both_ways(emu, jzio, monkeypatch, scheme, compressor):
    env_credentials(monkeypatch)
    monkeypatch.setenv("GOOGLE_AUTH_TOKEN_FOR_TESTING", TS_TOKEN)
    tag = "blosc" if compressor else "raw"
    bucket = f"arr-{scheme}-{tag}"
    for dtype in (np.uint8, np.uint16, np.float32):
        data = _volume(dtype, seed=np.dtype(dtype).itemsize)
        names = {}
        for side, zio in (("jax", jzio), ("port", tzio)):
            names[side] = f"{side}-{np.dtype(dtype).name}.zarr"
            want = _write(zio, f"{scheme}://{bucket}/{names[side]}", data,
                          compressor=compressor)
        jax_objs = _objects(emu, scheme, bucket, names["jax"] + "/")
        port_objs = _objects(emu, scheme, bucket, names["port"] + "/")
        assert sorted(jax_objs) == sorted(port_objs)
        assert len(jax_objs) == 11                 # .zarray, 10 chunks
        assert jax_objs[".zarray"] == port_objs[".zarray"]
        if compressor is None:
            assert jax_objs == port_objs
        else:
            assert _decoded(emu, scheme, bucket, names["jax"] + "/", dtype,
                            compressor) == _decoded(
                emu, scheme, bucket, names["port"] + "/", dtype, compressor)
        for reader, side in ((tzio, "jax"), (jzio, "port")):
            got = np.asarray(reader.open_zarr(
                f"{scheme}://{bucket}/{names[side]}")[...])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert tzio.zarr_exists(f"{scheme}://{bucket}/{names['jax']}")
        assert not tzio.zarr_exists(f"{scheme}://{bucket}/missing.zarr")
        with pytest.raises(FileExistsError):
            tzio.create_zarr(f"{scheme}://{bucket}/{names['jax']}", SHAPE,
                             dtype, CHUNKS)
        again = tzio.create_zarr(f"{scheme}://{bucket}/{names['jax']}",
                                 SHAPE, dtype, CHUNKS, allow_existing=True)
        np.testing.assert_array_equal(again[...], want)


# ------------------------------------------------------------ (c) crop

@pytest.mark.parametrize("src,dst", [("s3", "gs"), ("gs", "s3")])
def test_zarr_crop_bucket_to_bucket(emu, jzio, monkeypatch, src, dst):
    from mt3d_resenc_unet_torch.tools import zarr_crop as tcrop
    from mt3d_resenc_unet_tpu.tools import zarr_crop as jcrop
    env_credentials(monkeypatch)
    monkeypatch.setenv("GOOGLE_AUTH_TOKEN_FOR_TESTING", TS_TOKEN)
    data = _volume(np.uint16, seed=3)
    source = f"{src}://crop-src-{src}/vol.zarr"
    tzio.create_zarr(source, SHAPE, np.uint16, CHUNKS)[...] = data
    deleted, names = {}, {}
    bucket = f"crop-dst-{dst}"
    for side, tool in (("jax", jcrop), ("port", tcrop)):
        names[side] = f"{side}.zarr"
        out = f"{dst}://{bucket}/{names[side]}"
        old = tzio.create_zarr(out, (8, 8, 12), np.uint8, (4, 4, 4))
        old[...] = 1                             # 12 old chunks
        mark = len(emu.records)
        # 12 chunks: the tools leave no write unawaited below 16
        tool.cut_zarr_bounding_box(source, out, 1, 11, 2, 19, 0, 16)
        deleted[side] = sorted(
            urllib.parse.unquote(r["target"].split("?")[0]).rsplit(
                names[side] + "/", 1)[1]
            for r in emu.since(mark) if r["method"] == "DELETE")
    assert len(deleted["jax"]) == 13
    assert deleted["jax"] == deleted["port"]
    jax_objs = _decoded(emu, dst, bucket, names["jax"] + "/", np.uint16,
                        tzio.DEFAULT_COMPRESSOR)
    port_objs = _decoded(emu, dst, bucket, names["port"] + "/", np.uint16,
                         tzio.DEFAULT_COMPRESSOR)
    assert jax_objs == port_objs and len(jax_objs) > 1
    meta = json.loads(jax_objs[".zarray"])
    assert meta["compressor"]["cname"] == "zstd" and meta["shape"] == [
        10, 17, 16]
    for name in names.values():
        np.testing.assert_array_equal(
            tzio.open_zarr(f"{dst}://{bucket}/{name}")[...],
            data[1:11, 2:19, 0:16])


# ------------------------------------------------------------ (d) CAS

_WRITER = r"""
import sys
import numpy as np
from mt3d_resenc_unet_torch.data import zio
url, path = sys.argv[1], sys.argv[2]
half, rounds = int(sys.argv[3]), int(sys.argv[4])
zio.s3_endpoint = lambda bucket, region=None: f"{url}/{bucket}"
vol = zio.open_zarr(path, writable=True)
mine = np.s_[4 * half:4 * half + 4]
for r in range(1, rounds + 1):
    vol[mine] = r + 100 * half
    got = vol[mine]
    assert (got == r + 100 * half).all(), (half, r)
print("done", half)
"""


@pytest.mark.parametrize("scheme", ["s3", "gs"])
def test_two_processes_write_halves_of_one_chunk(emu, monkeypatch, scheme):
    env_credentials(monkeypatch)
    monkeypatch.setenv("GOOGLE_AUTH_TOKEN_FOR_TESTING", TS_TOKEN)
    path = f"{scheme}://slow-cas/one.zarr"      # first two reads meet
    tzio.create_zarr(path, (8, 8, 8), np.uint8, (8, 8, 8))
    mark = len(emu.records)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER, emu.url, path, str(half), "20"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for half in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = tzio.open_zarr(path)[...]
    assert (got[:4] == 20).all() and (got[4:] == 120).all()
    refused = [r for r in emu.since(mark) if r["status"] == 412]
    assert refused, "no write was overtaken: the test saw no contention"


# ------------------------------------------------------------ (e) anonymous

def test_no_credentials_unsigned_as_tensorstore(emu, jzio):
    data = _volume(np.uint8)
    mark = len(emu.records)
    _s3_session(jzio, "anon-ts", data)
    theirs = emu.since(mark)
    mark = len(emu.records)
    _s3_session(tzio, "anon-port", data)
    mine = emu.since(mark)
    amz = {}
    for side in (theirs, mine):
        assert side and not any(
            k in r["headers"] for r in side
            for k in ("authorization", "x-amz-security-token"))
        for r in side:
            amz.setdefault(_kind(r), set()).add(tuple(sorted(
                k for k in r["headers"] if k.startswith("x-amz-"))))
    for kind in ("GET", "PUT .zarray", "PUT chunk", "list", "DELETE"):
        assert len(amz[kind]) == 1, (kind, amz[kind])
    assert remote_auth.aws_credentials() is None
    # gs: no token source (the metadata root answers as no metadata server)
    assert remote_auth.gcs_authorization() is None
    mark = len(emu.records)
    tzio.create_zarr("gs://anon-gs/vol.zarr", SHAPE, np.uint8, CHUNKS)[
        0:8] = 1
    assert np.asarray(tzio.open_zarr("gs://anon-gs/vol.zarr")[0:8]).all()
    gcs = [r for r in emu.since(mark) if "storage/v1" in r["target"]]
    assert gcs and not any("authorization" in r["headers"] for r in gcs)


# ------------------------------------------------------------ (f) tokens

@pytest.fixture(scope="module")
def rsa_key():
    crypto = pytest.importorskip(
        "cryptography.hazmat.primitives.asymmetric.rsa")
    from cryptography.hazmat.primitives import serialization
    key = crypto.generate_private_key(public_exponent=65537, key_size=2048)
    pems = {fmt: key.private_bytes(
        serialization.Encoding.PEM, getattr(serialization.PrivateFormat, fmt),
        serialization.NoEncryption()).decode()
        for fmt in ("PKCS8", "TraditionalOpenSSL")}
    return key, pems


def test_rs256_equals_cryptography(rsa_key):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding
    key, pems = rsa_key
    nums = key.private_numbers()
    for message in (b"", b"header.claims", bytes(range(256)) * 9):
        want = key.sign(message, padding.PKCS1v15(), hashes.SHA256())
        for pem in pems.values():
            assert remote_auth.rs256_sign(pem, message) == want
    for pem in pems.values():
        assert remote_auth.rsa_private_key(pem)[:3] == (
            nums.public_numbers.n, nums.public_numbers.e, nums.d)


def test_service_account_and_refresh_grants(emu, isolated, monkeypatch,
                                            rsa_key):
    key, pems = rsa_key
    pub = key.public_key().public_numbers()
    emu.jwt = (pub.n, pub.e, "sa@test.iam")
    info = {"type": "service_account", "client_email": "sa@test.iam",
            "private_key_id": "kid-1", "private_key": pems["PKCS8"],
            "token_uri": "https://oauth2.invalid/token"}
    path = isolated / "sa.json"
    path.write_text(json.dumps(info))
    monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", str(path))
    grants = len(emu.grants)
    mark = len(emu.records)
    tzio.create_zarr("gs://sa-bucket/vol.zarr", SHAPE, np.uint8,
                     CHUNKS)[...] = 7
    assert (np.asarray(tzio.open_zarr("gs://sa-bucket/vol.zarr")[...])
            == 7).all()
    assert len(emu.grants) == grants + 1                # cached after
    kind, head, claims = emu.grants[-1]
    assert kind == "jwt" and head == {"alg": "RS256", "kid": "kid-1",
                                      "typ": "JWT"}
    assert claims["iss"] == "sa@test.iam"
    assert claims["scope"] == "https://www.googleapis.com/auth/cloud-platform"
    assert claims["aud"] == "https://www.googleapis.com/oauth2/v3/token"
    assert claims["exp"] - claims["iat"] == 3600
    gcs = [r for r in emu.since(mark) if "storage/v1" in r["target"]]
    token = f"Bearer issued-{len(emu.grants)}-"
    assert gcs and all(r["headers"]["authorization"].startswith(token)
                       for r in gcs)
    # a token within the margin of its end is fetched again
    monkeypatch.setattr(remote_auth, "_providers", {})
    emu.expires_in = remote_auth.TOKEN_MARGIN_S
    remote_auth.gcs_authorization()
    remote_auth.gcs_authorization()
    assert len(emu.grants) == grants + 3
    # gcloud's authorized_user file, found under CLOUDSDK_CONFIG
    monkeypatch.delenv("GOOGLE_APPLICATION_CREDENTIALS")
    monkeypatch.setattr(remote_auth, "_providers", {})
    emu.expires_in = 3600
    (isolated / "gcloud" / "application_default_credentials.json"
     ).write_text(json.dumps({"type": "authorized_user", "client_id": "cid",
                              "client_secret": "csecret",
                              "refresh_token": "rtoken"}))
    assert remote_auth.gcs_authorization().startswith(
        f"Bearer issued-{len(emu.grants)}-")
    kind, form, _ = emu.grants[-1]
    assert kind == "refresh" and form == {
        "client_id": "cid", "client_secret": "csecret",
        "refresh_token": "rtoken", "grant_type": "refresh_token"}


# ------------------------------------------------------------ (g) secrets

def _text(exc):
    parts = []
    while exc is not None:
        parts += [str(exc), repr(exc)]
        exc = exc.__cause__ or exc.__context__
    return " ".join(parts)


def test_errors_carry_no_secret(emu, isolated, monkeypatch, rsa_key):
    env_credentials(monkeypatch, session=True)
    tzio.create_zarr("s3://deny/vol.zarr", SHAPE, np.uint8, CHUNKS)[...] = 1
    emu.deny = True
    mark = len(emu.records)
    with pytest.raises(OSError, match="HTTP 403") as err:
        tzio.open_zarr("s3://deny/vol.zarr")
    emu.deny = False
    seen = emu.since(mark)
    assert len(seen) == 1 and "authorization" in seen[0]["headers"]
    forbidden = (EXAMPLE_SECRET, SESSION, "Signature=", "AWS4-HMAC")
    text = _text(err.value)
    assert not any(s in text for s in forbidden), text
    assert "GET http://127.0.0.1" in text and "deny/vol.zarr/.zarray" in text
    # transient answers are retried, then raise without the headers
    emu.fail = [503, 503]
    assert tzio.zarr_exists("s3://deny/vol.zarr")
    emu.fail = [503] * tzio._Remote.attempts
    with pytest.raises(OSError, match="HTTP 503") as err:
        tzio.open_zarr("s3://deny/vol.zarr")[...]
    assert not any(s in _text(err.value) for s in forbidden)
    # gs: a refused bearer token and a refused grant
    monkeypatch.setenv("GOOGLE_AUTH_TOKEN_FOR_TESTING", "secret-bearer")
    tzio.create_zarr("gs://deny-gs/vol.zarr", SHAPE, np.uint8, CHUNKS)
    emu.deny = True
    with pytest.raises(OSError, match="HTTP 403") as err:
        tzio.open_zarr("gs://deny-gs/vol.zarr")
    emu.deny = False
    assert "secret-bearer" not in _text(err.value)
    monkeypatch.delenv("GOOGLE_AUTH_TOKEN_FOR_TESTING")
    monkeypatch.setattr(remote_auth, "_providers", {})
    _, pems = rsa_key
    sa = isolated / "sa.json"
    sa.write_text(json.dumps({"type": "service_account",
                              "client_email": "sa@test.iam",
                              "private_key_id": "kid-2",
                              "private_key": pems["PKCS8"]}))
    monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", str(sa))
    emu.fail = [400]
    with pytest.raises(OSError, match="HTTP 400") as err:
        remote_auth.gcs_authorization()
    text = _text(err.value)
    assert "PRIVATE KEY" not in text and "assertion" not in text
    assert "eyJ" not in text                       # no JWT


# ------------------------------------------------------------ golden

def test_golden_requests_replay_without_tensorstore(monkeypatch):
    """The requests tensorstore signed when the fixtures were recorded,
    signed again by the port (no tensorstore, no server)."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    kinds = set()
    for case in manifest["s3"]:
        c = case["credentials"]
        creds = remote_auth.AwsCredentials(c["access_key"], c["secret_key"],
                                           c.get("session_token"))
        for r in case["requests"]:
            kinds.add((case["name"], _kind(r)))
            assert replay(r, creds) == r["headers"]["authorization"]
    for name in ("env", "session"):
        assert {(name, k) for k in ("GET", "HEAD", "PUT .zarray",
                                    "PUT chunk", "list", "DELETE")} <= kinds
    jwt = manifest["jwt"]
    pem = (FIXTURES / jwt["key_file"]).read_text()
    head = jwt["signing_input"].encode()
    assert base64.urlsafe_b64encode(remote_auth.rs256_sign(pem, head)
                                    ).rstrip(b"=").decode() == jwt["signature"]
    info = json.loads((FIXTURES / jwt["service_account_file"]).read_text())
    info["private_key"] = pem
    assert remote_auth.service_account_jwt(info, jwt["iat"]) == \
        f"{jwt['signing_input']}.{jwt['signature']}"
