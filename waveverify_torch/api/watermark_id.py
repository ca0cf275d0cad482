"""WatermarkID — 16-bit watermark identity abstraction (a copy of
``waveverify_tpu/api/watermark_id.py``; the port imports nothing of the
JAX package).

Semantics match the reference `waveverify/watermark_id.py:16-376` one-to-one
(MD5-based hashing, timestamp bit packing, license code table) so IDs created
with either implementation are interchangeable.
"""

from __future__ import annotations

import hashlib
import logging
from datetime import datetime
from typing import Any, Dict, Optional, Union

logger = logging.getLogger(__name__)


class WatermarkID:
    """A 16-bit watermark identity (65,536 possible values).

    Use the factory classmethods (`for_creator`, `for_timestamp`,
    `for_license`, `for_tracking`, `custom`) rather than the constructor.
    """

    def __init__(self, bits: str):
        self._validate_bits(bits)
        self.bits = bits
        self.metadata: Dict[str, Any] = {}
        assert len(self.bits) == 16

    @staticmethod
    def _validate_bits(bits: str) -> None:
        if not isinstance(bits, str):
            raise TypeError(f"Bits must be string, got {type(bits)}")
        if len(bits) != 16:
            raise ValueError(f"Bits must be exactly 16 characters, got {len(bits)}")
        if not all(c in "01" for c in bits):
            raise ValueError(f"Bits must contain only 0 and 1, got: {bits}")

    # -- factories ----------------------------------------------------------

    @classmethod
    def for_creator(cls, creator_id: str) -> "WatermarkID":
        """Deterministic creator watermark: first 2 bytes of MD5(creator_id)."""
        if not creator_id or not isinstance(creator_id, str):
            raise ValueError("Creator ID must be a non-empty string")
        hash_bytes = hashlib.md5(creator_id.encode("utf-8")).digest()
        bits = "".join(format(b, "08b") for b in hash_bytes[:2])
        instance = cls(bits)
        instance.metadata = {
            "type": "creator",
            "id": creator_id,
            "hash_method": "md5_first_2_bytes",
        }
        return instance

    @classmethod
    def for_timestamp(cls, timestamp: Optional[datetime] = None) -> "WatermarkID":
        """Timestamp watermark: 5b year-2024 | 4b month | 5b day | 2b day-quarter."""
        if timestamp is None:
            timestamp = datetime.now()
        year_offset = timestamp.year - 2024
        if year_offset < 0 or year_offset > 31:
            raise ValueError(
                f"Year must be between 2024 and 2055, got {timestamp.year}"
            )
        quarter = timestamp.hour // 6
        bits = (
            f"{year_offset:05b}"
            f"{timestamp.month:04b}"
            f"{timestamp.day:05b}"
            f"{quarter:02b}"
        )
        instance = cls(bits)
        instance.metadata = {
            "type": "timestamp",
            "time": timestamp.isoformat(),
            "year": timestamp.year,
            "month": timestamp.month,
            "day": timestamp.day,
            "quarter": quarter,
        }
        return instance

    @classmethod
    def for_license(cls, license_type: str) -> "WatermarkID":
        """License watermark using the reference's code table
        (reference watermark_id.py:159-169)."""
        licenses = {
            "CC0": 0x0000,
            "CC-BY": 0x0001,
            "CC-BY-SA": 0x0002,
            "CC-BY-NC": 0x0003,
            "CC-BY-NC-SA": 0x0004,
            "CC-BY-ND": 0x0005,
            "CC-BY-NC-ND": 0x0006,
            "ALL-RIGHTS": 0xFFFF,
            "CUSTOM": 0x8000,
        }
        normalized = license_type.upper().replace("_", "-")
        if normalized in licenses:
            code = licenses[normalized]
        else:
            base_license = normalized.split("-")[0] if "-" in normalized else normalized
            if base_license == "CC" and "-" in normalized:
                parts = normalized.split("-")
                base_license = "-".join(parts[: min(3, len(parts))])
            code = licenses.get(base_license, licenses["CUSTOM"])
        if code == licenses["CUSTOM"]:
            hash_val = hashlib.md5(license_type.encode()).digest()
            code = 0x8000 | (int.from_bytes(hash_val[:2], "big") & 0x7FFF)
        bits = format(code, "016b")
        instance = cls(bits)
        instance.metadata = {
            "type": "license",
            "license": license_type,
            "code": f"0x{code:04X}",
            "is_custom": code >= 0x8000,
        }
        return instance

    @classmethod
    def for_tracking(cls, tracking_id: str) -> "WatermarkID":
        """Tracking watermark: direct numeric encode if <=65535 else MD5 hash."""
        if not tracking_id or not isinstance(tracking_id, str):
            raise ValueError("Tracking ID must be a non-empty string")
        if tracking_id.isdigit() and len(tracking_id) <= 5:
            tracking_num = int(tracking_id)
            if tracking_num <= 65535:
                bits = format(tracking_num, "016b")
                id_type = "numeric"
            else:
                hash_bytes = hashlib.md5(tracking_id.encode("utf-8")).digest()
                bits = "".join(format(b, "08b") for b in hash_bytes[:2])
                id_type = "hashed"
        else:
            hash_bytes = hashlib.md5(tracking_id.encode("utf-8")).digest()
            bits = "".join(format(b, "08b") for b in hash_bytes[:2])
            id_type = "hashed"
        instance = cls(bits)
        instance.metadata = {"type": "tracking", "id": tracking_id, "id_type": id_type}
        return instance

    @classmethod
    def custom(cls, value: Union[str, int, bytes]) -> "WatermarkID":
        """Custom watermark from a 16-char bit string, int 0-65535, or 2 bytes."""
        if isinstance(value, str):
            if len(value) == 16 and all(c in "01" for c in value):
                bits = value
            else:
                raise ValueError(
                    f"String must be 16-bit binary (got {len(value)} chars). "
                    f"Example: '1010101010101010'"
                )
        elif isinstance(value, int):
            if 0 <= value <= 65535:
                bits = format(value, "016b")
            else:
                raise ValueError(f"Integer must be 0-65535, got {value}")
        elif isinstance(value, bytes):
            if len(value) == 2:
                bits = "".join(format(b, "08b") for b in value)
            else:
                raise ValueError(f"Bytes must be exactly 2 bytes, got {len(value)}")
        else:
            raise TypeError(
                f"Unsupported type {type(value)}. Use string, int, or bytes."
            )
        instance = cls(bits)
        instance.metadata = {
            "type": "custom",
            "value": str(value),
            "value_type": type(value).__name__,
        }
        return instance

    # -- conversions --------------------------------------------------------

    def to_bits(self) -> str:
        return self.bits

    def to_hex(self) -> str:
        return format(int(self.bits, 2), "04X")

    def to_int(self) -> int:
        return int(self.bits, 2)

    def to_bytes(self) -> bytes:
        val = self.to_int()
        return bytes([(val >> 8) & 0xFF, val & 0xFF])

    # -- dunder -------------------------------------------------------------

    def __str__(self) -> str:
        meta_type = self.metadata.get("type", "unknown")
        if meta_type == "creator":
            return f"WatermarkID(creator='{self.metadata['id']}')"
        if meta_type == "timestamp":
            return f"WatermarkID(time='{self.metadata['time']}')"
        if meta_type == "license":
            return f"WatermarkID(license='{self.metadata['license']}')"
        if meta_type == "tracking":
            return f"WatermarkID(tracking='{self.metadata['id']}')"
        if meta_type == "custom":
            return f"WatermarkID(custom={self.to_hex()})"
        return f"WatermarkID(bits='{self.bits}')"

    def __repr__(self) -> str:
        return f"WatermarkID(bits='{self.bits}', metadata={self.metadata})"

    def __eq__(self, other) -> bool:
        if isinstance(other, WatermarkID):
            return self.bits == other.bits
        return False

    def __hash__(self) -> int:
        return hash(self.bits)
