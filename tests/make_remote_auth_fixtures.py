"""Writes ``tests/data/remote_auth/``: the S3 requests tensorstore signs,
for the port's signer to replay where there is no tensorstore (the CPU
test ``test_golden_requests_replay_without_tensorstore`` and
``chip_smoke.py`` phase 22a), and a test-only RSA key with a JWT that
``cryptography`` signed.

    JAX_PLATFORMS=cpu python tests/make_remote_auth_fixtures.py

Needs tensorstore, the JAX package and ``cryptography``. The JAX package's
``create_zarr`` / ``open_zarr`` run against the S3 emulator
``tests/bucket_emulator.py`` on 127.0.0.1 with AWS's
published example credentials, once without and once with a session
token; every request they sign (GET, HEAD, PUT of ``.zarray`` and of a
chunk, ListObjectsV2, DELETE) goes into ``manifest.json`` with its signed
headers, its body's SHA-256 and its ``Authorization``.
"""

import base64
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

from bucket_emulator import BucketEmulator  # noqa: E402
from test_torch_port_remote_auth import (EXAMPLE_KEY, EXAMPLE_SECRET,  # noqa
                                         SESSION, _parse_auth)

OUT = HERE / "data" / "remote_auth"
JWT_IAT = 1767225600
SERVICE_ACCOUNT = {"type": "service_account", "project_id": "test",
                   "private_key_id": "test-key-1",
                   "client_email": "sa@test.iam.gserviceaccount.com",
                   "token_uri": "https://oauth2.googleapis.com/token"}


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def record_s3(emu, jzio, name, session):
    for var in list(os.environ):
        if var.startswith("AWS_"):
            del os.environ[var]
    os.environ.update(AWS_EC2_METADATA_DISABLED="true",
                      AWS_CONFIG_FILE=os.devnull,
                      AWS_SHARED_CREDENTIALS_FILE=os.devnull,
                      AWS_ACCESS_KEY_ID=EXAMPLE_KEY,
                      AWS_SECRET_ACCESS_KEY=EXAMPLE_SECRET)
    if session:
        os.environ["AWS_SESSION_TOKEN"] = SESSION
    mark = len(emu.records)
    path = f"s3://golden-{name}/vol.zarr"
    data = np.arange(12 * 20 * 18, dtype=np.uint16).reshape(12, 20, 18)
    vol = jzio.create_zarr(path, data.shape, np.uint16, (8, 8, 8))
    vol[0:8, 0:16] = data[0:8, 0:16]
    vol[2:10, 5:12, 3:11] = data[2:10, 5:12, 3:11]
    np.asarray(jzio.open_zarr(path)[...])
    jzio.create_zarr(path, data.shape, np.uint16, (8, 8, 8),
                     delete_existing=True)
    requests = []
    for r in emu.since(mark):
        auth = r["headers"].get("authorization")
        if auth is None:
            continue
        names = _parse_auth(auth)[0]
        requests.append({
            "method": r["method"], "target": r["target"],
            "headers": {**{n: r["headers"][n] for n in names},
                        "authorization": auth},
            "body_sha256": r["body_sha256"]})
    creds = {"access_key": EXAMPLE_KEY, "secret_key": EXAMPLE_SECRET}
    if session:
        creds["session_token"] = SESSION
    return {"name": name, "credentials": creds, "requests": requests}


def main():
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    from mt3d_resenc_unet_tpu.data import zio as jzio
    emu = BucketEmulator(secrets={EXAMPLE_KEY: EXAMPLE_SECRET})
    original = jzio._kvstore_spec

    def spec(path):
        out = original(path)
        if out["driver"] == "s3":
            out["endpoint"] = emu.url
        return out

    jzio._kvstore_spec = spec
    try:
        s3 = [record_s3(emu, jzio, "env", False),
              record_s3(emu, jzio, "session", True)]
    finally:
        emu.close()
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.private_bytes(serialization.Encoding.PEM,
                            serialization.PrivateFormat.PKCS8,
                            serialization.NoEncryption()).decode()
    header = {"alg": "RS256", "kid": SERVICE_ACCOUNT["private_key_id"],
              "typ": "JWT"}
    claims = {"aud": "https://www.googleapis.com/oauth2/v3/token",
              "exp": JWT_IAT + 3600, "iat": JWT_IAT,
              "iss": SERVICE_ACCOUNT["client_email"],
              "scope": "https://www.googleapis.com/auth/cloud-platform"}
    signing_input = ".".join(
        _b64url(json.dumps(part, separators=(",", ":"),
                           sort_keys=True).encode())
        for part in (header, claims))
    signature = key.sign(signing_input.encode(), padding.PKCS1v15(),
                         hashes.SHA256())
    pub = key.public_key().public_numbers()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "test_rsa_key.pem").write_text(pem)
    (OUT / "service_account.json").write_text(
        json.dumps(SERVICE_ACCOUNT, indent=1) + "\n")
    manifest = {
        "about": "tensorstore's signed S3 requests on a loopback emulator "
                 "(AWS's example credentials) and a JWT signed RS256 by "
                 "cryptography with a test-only key; written by "
                 "tests/make_remote_auth_fixtures.py",
        "s3": s3,
        "jwt": {"key_file": "test_rsa_key.pem",
                "service_account_file": "service_account.json",
                "public_n": format(pub.n, "x"), "public_e": pub.e,
                "iat": JWT_IAT, "signing_input": signing_input,
                "signature": _b64url(signature)}}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"wrote {OUT}: " + ", ".join(
        f"{c['name']} {len(c['requests'])} requests" for c in s3))


if __name__ == "__main__":
    main()
