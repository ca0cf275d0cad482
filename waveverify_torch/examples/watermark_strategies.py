"""WatermarkID strategy demos, all five factories (the port's counterpart
of ``examples/watermark_strategies.py``). It builds no model, so it takes
no device or checkpoint.

The 16-bit identity space supports several allocation strategies; pick the
one matching your provenance model.

Run:  python -m waveverify_torch.examples.watermark_strategies
"""

from datetime import datetime

from waveverify_torch import WatermarkID


def show(title: str, wm: WatermarkID) -> None:
    print(f"{title:<42} bits={wm.to_bits()} hex={wm.to_hex()} int={wm.to_int()}")


def main() -> None:
    print("== creator IDs (stable hash of a name) ==")
    for name in ("studio_abc", "indie_artist_42", "podcast_network"):
        show(f"for_creator({name!r})", WatermarkID.for_creator(name))

    print("\n== timestamps (year/month/day/quarter-of-day packing) ==")
    show("for_timestamp(now)", WatermarkID.for_timestamp())
    show("for_timestamp(2025-03-15 14:00)",
         WatermarkID.for_timestamp(datetime(2025, 3, 15, 14, 0)))

    print("\n== license types (code table + custom hash) ==")
    for lic in ("all_rights_reserved", "cc_by", "cc_by_sa", "public_domain",
                "custom_license_xyz"):
        show(f"for_license({lic!r})", WatermarkID.for_license(lic))

    print("\n== tracking IDs (numeric direct / hashed) ==")
    show("for_tracking('12345')", WatermarkID.for_tracking("12345"))
    show("for_tracking('order-2024-xyz')",
         WatermarkID.for_tracking("order-2024-xyz"))

    print("\n== custom values (bits / int / bytes) ==")
    show("custom('1010101010101010')", WatermarkID.custom("1010101010101010"))
    show("custom(0xBEEF)", WatermarkID.custom(0xBEEF))
    show("custom(b'\\x12\\x34')", WatermarkID.custom(b"\x12\x34"))

    print("\n== equality / hashing ==")
    a = WatermarkID.for_creator("studio_abc")
    b = WatermarkID.for_creator("studio_abc")
    c = WatermarkID.for_creator("other")
    print(f"same creator twice equal: {a == b}; different: {a == c}")
    print(f"usable as dict keys: {len({a: 1, b: 2, c: 3})} unique of 3")


if __name__ == "__main__":
    main()
