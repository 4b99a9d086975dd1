"""Self-signed TLS material for cluster transport encryption.

(reference: the reference pairs its token validator with gRPC TLS,
src/ray/rpc/authentication/authentication_token_validator.h:26 +
grpc_server TLS options; here one self-signed cert is generated at
`start --head --tls`, servers present it, and every client PINS it —
no CA hierarchy, which is the right trust model for a single-operator
cluster: possession of the cert file is the trust root, and the auth
token never crosses the wire in cleartext.)
"""

from __future__ import annotations

import datetime
import ipaddress
import os


def generate_self_signed(cert_path: str, key_path: str) -> None:
    """Write a fresh self-signed cert + key valid for any host/IP (the
    cert is pinned by clients, so SAN breadth is not a weakness)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "ray_tpu_torch-cluster")]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=3650))
        .add_extension(
            x509.SubjectAlternativeName(
                [
                    x509.DNSName("*"),
                    x509.DNSName("localhost"),
                    x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                ]
            ),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    for path, data, mode in (
        (
            key_path,
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption(),
            ),
            0o600,
        ),
        (cert_path, cert.public_bytes(serialization.Encoding.PEM), 0o644),
    ):
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
