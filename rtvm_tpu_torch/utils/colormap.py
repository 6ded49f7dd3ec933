"""cv2's ``COLORMAP_PLASMA`` as data, and ``apply_colormap`` (the port's
``cv2.applyColorMap`` for that map; the card has no cv2).

``PLASMA_BGR`` is ``cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
cv2.COLORMAP_PLASMA)[:, 0]``, taken from OpenCV 5.0: 256 BGR triples.
"""

from __future__ import annotations

import numpy as np

PLASMA_BGR = np.frombuffer(bytes.fromhex(
    "87080d8807108907138a07168c06198d061b8e061d8f062090062291062491052692052893052a94052c95052e96052f"
    "9705319705339804359904379a04389a043a9b043c9c043e9c043f9d04419e03439e03449f03469f0348a00349a1034b"
    "a1024ca2024ea20250a30251a30253a40255a40156a40158a50159a5015ba6015ca6015ea60160a70061a70063a70064"
    "a70066a80067a80069a8006aa8006ca8006ea8006fa80071a80172a80174a80175a80177a80178a8027aa8027ba8037d"
    "a8037ea80480a70481a70583a70584a60686a60787a60888a5098aa50a8ba50b8da40c8ea40d8fa30e91a30f92a21094"
    "a11195a11396a014989f15999f169a9e179c9d189d9d199e9c1aa09b1ba19a1da29a1ea3991fa59820a69721a79622a8"
    "9523aa9424ab9426ac9327ad9228ae9129b0902ab18f2bb28e2cb38d2eb48c2fb58b30b68a31b78932b88833ba8834bb"
    "8735bc8637bd8538be8439bf833ac0823bc1813cc2803dc37f3ec47e40c57d41c67c42c77b43c87a44c97a45ca7946cb"
    "7847cc7749cc764acd754bce744ccf734dd0724ed1714fd27151d37052d46f53d56e54d56d55d66c56d76b57d86a58d9"
    "6a5ada695bda685cdb675ddc665edd655fde6461de6362df6363e06264e16165e26066e25f68e35e69e45d6ae55d6be5"
    "5c6ce65b6ee75a6fe75970e85871e95772e95774ea5675eb5576eb5477ec5379ed527aed517bee517cef507eef4f7ff0"
    "4e80f04d81f14c83f14b84f24b85f34a87f34988f44889f4478bf5468cf5458df6448ff64490f74391f74293f74194f8"
    "4095f83f97f93e98f93e9af93d9bfa3c9cfa3b9efa3a9ffb39a1fb38a2fb38a3fc37a5fc36a6fc35a8fc34a9fc33abfd"
    "33acfd32aefd31affd30b1fd2fb2fd2fb4fd2eb5fd2db7fe2cb8fe2cbafe2bbbfe2abdfe2abefe29c0fe29c2fd28c3fd"
    "27c5fd27c6fd27c8fd26cafd26cbfd25cdfc25cefc25d0fc25d2fc24d3fb24d5fb24d7fb24d8fa24dafa24dcf925ddf9"
    "25dff825e1f825e2f725e4f726e6f626e8f626e9f527ebf527edf427eef327f0f327f2f226f4f125f5f124f7f021f9f0"
), np.uint8).reshape(256, 3)


def apply_colormap(gray_u8: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray_u8, cv2.COLORMAP_PLASMA)``: [H, W] uint8 ->
    [H, W, 3] uint8 BGR."""
    gray_u8 = np.asarray(gray_u8)
    if gray_u8.dtype != np.uint8:
        raise TypeError(f"apply_colormap takes uint8 levels, got {gray_u8.dtype}")
    return PLASMA_BGR[gray_u8]
