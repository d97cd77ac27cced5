"""CycloneDDS bridge for the NeRFCapture iPhone app (host-side I/O).

Counterpart of splatam_tpu/live/dds.py (reference: scripts/iphone_demo.py:
39-92,546-553): the SplatCaptureFrame IDL struct on topic "Frames" with
reliable QoS and 10MB socket buffers. DDS is host-side I/O; frames enter
the SLAM loop as numpy arrays. CycloneDDS is an optional dependency: this
module imports without it, and make_reader then raises ImportError.
"""
from __future__ import annotations

try:
    from dataclasses import dataclass

    import cyclonedds.idl as idl
    import cyclonedds.idl.annotations as annotate
    import cyclonedds.idl.types as types
    from cyclonedds.core import Policy, Qos
    from cyclonedds.domain import Domain, DomainParticipant
    from cyclonedds.sub import DataReader
    from cyclonedds.topic import Topic
    from cyclonedds.util import duration

    HAVE_DDS = True
except ImportError:  # pragma: no cover - optional dependency
    HAVE_DDS = False

if HAVE_DDS:

    @dataclass
    @annotate.final
    @annotate.autoid("sequential")
    class SplatCaptureFrame(idl.IdlStruct, typename="SplatCaptureData.SplatCaptureFrame"):
        id: types.uint32
        annotate.key("id")
        timestamp: types.float64
        fl_x: types.float32
        fl_y: types.float32
        cx: types.float32
        cy: types.float32
        transform_matrix: types.array[types.float32, 16]
        width: types.uint32
        height: types.uint32
        image: types.sequence[types.uint8]
        has_depth: bool
        depth_width: types.uint32
        depth_height: types.uint32
        depth_scale: types.float32
        depth_image: types.sequence[types.uint8]

    DDS_CONFIG = """<?xml version="1.0" encoding="UTF-8" ?> \
<CycloneDDS xmlns="https://cdds.io/config" xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" xsi:schemaLocation="https://cdds.io/config https://raw.githubusercontent.com/eclipse-cyclonedds/cyclonedds/master/etc/cyclonedds.xsd"> \
    <Domain id="any"> \
        <Internal> \
            <MinimumSocketReceiveBufferSize>10MB</MinimumSocketReceiveBufferSize> \
        </Internal> \
        <Tracing> \
            <Verbosity>config</Verbosity> \
            <OutputFile>stdout</OutputFile> \
        </Tracing> \
    </Domain> \
</CycloneDDS> \
"""

    def make_reader():
        """Domain + participant + reliable reader on topic 'Frames'."""
        domain = Domain(domain_id=0, config=DDS_CONFIG)
        participant = DomainParticipant()
        qos = Qos(Policy.Reliability.Reliable(max_blocking_time=duration(seconds=1)))
        topic = Topic(participant, "Frames", SplatCaptureFrame, qos=qos)
        return domain, DataReader(participant, topic)

else:

    def make_reader():
        raise ImportError(
            "cyclonedds is not installed; the live NeRFCapture bridge needs it "
            "(pip install cyclonedds)."
        )
