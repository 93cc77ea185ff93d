"""AVCDecoderConfigurationRecord (avcC) construction (ISO 14496-15 §5.2.4).

Built by the reference in each container muxer (matroska.c:137-158,
mp4_lsmash via lsmash_setup_h264_specific_parameters, flv.c:190-219).
"""

from __future__ import annotations


def parse_avcc(data: bytes):
    """avcC extradata -> (sps_nals, pps_nals, nal_length_size).

    The reference accepts avcC extradata on the decompress side and
    switches the AU framing to length-prefixed (codec.c:2032-2044); this
    is the parse half of build_avcc."""
    if len(data) < 7 or data[0] != 1:
        raise ValueError("not an avcC record")
    nls = (data[4] & 3) + 1
    pos = 5
    n_sps = data[pos] & 0x1F
    pos += 1
    sps = []
    for _ in range(n_sps):
        ln = int.from_bytes(data[pos:pos + 2], "big")
        pos += 2
        sps.append(data[pos:pos + ln])
        pos += ln
    n_pps = data[pos]
    pos += 1
    pps = []
    for _ in range(n_pps):
        ln = int.from_bytes(data[pos:pos + 2], "big")
        pos += 2
        pps.append(data[pos:pos + ln])
        pos += ln
    return sps, pps, nls


def build_avcc(sps: bytes, pps: bytes, nal_length_size: int = 4) -> bytes:
    """sps/pps: raw NAL payloads including the NAL header byte."""
    profile_idc = sps[1]
    profile_compat = sps[2]
    level_idc = sps[3]
    out = bytearray()
    out.append(1)  # configurationVersion
    out.append(profile_idc)
    out.append(profile_compat)
    out.append(level_idc)
    out.append(0xFC | (nal_length_size - 1))
    out.append(0xE0 | 1)  # numOfSequenceParameterSets
    out += len(sps).to_bytes(2, "big")
    out += sps
    out.append(1)  # numOfPictureParameterSets
    out += len(pps).to_bytes(2, "big")
    out += pps
    return bytes(out)
