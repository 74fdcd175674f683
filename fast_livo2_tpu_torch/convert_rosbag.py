"""Convert a ROS1 bag to the npz sequence layout of io/dataset.py: the
PyTorch port's counterpart of scripts/convert_rosbag.py, flag for flag.

    python -m fast_livo2_tpu_torch.convert_rosbag <bag> <out_dir> \\
        --lidar-type 1 --lid-topic /livox/lidar --imu-topic /livox/imu \\
        --img-topic /left_camera/image [--blind 0.8] [--filter-num 1]

then `python -m fast_livo2_tpu_torch.run --seq <out_dir> ...`.

The bag is read by the port's own io/rosbag.py (ROS1 v2.0, uncompressed
and bz2 chunks), the points are decoded by the port's models/lidar.py,
and the sequence is written by the port's io/dataset.save_sequence, so no
module of the JAX package is needed. Where the external `rosbags` package
is installed it reads the bag instead, as in the JAX script (it covers
more codecs, e.g. lz4 chunks and ROS2 bags); it is optional and imported
only here. A sensor_msgs/CompressedImage needs OpenCV (`cv2`), imported
only when such a message arrives; without it the conversion stops with
an error that says so. Raw sensor_msgs/Image messages need neither.
"""

import argparse
from pathlib import Path

import numpy as np

from .io import dataset
from .io import rosbag as bag_mod
from .models import lidar as lidar_mod

_PC2_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
               7: "f4", 8: "f8"}


def pointcloud2_to_fields(msg):
    """Structured-array view of a PointCloud2 message."""
    names, formats, offsets = [], [], []
    for f in msg.fields:
        names.append(f.name)
        formats.append(_PC2_DTYPES[f.datatype])
        offsets.append(f.offset)
    dtype = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                      "itemsize": msg.point_step})
    arr = np.frombuffer(msg.data, dtype=dtype, count=msg.width * msg.height)
    return {n: np.ascontiguousarray(arr[n]) for n in names}


def livox_to_fields(msg):
    """Field dict from a livox CustomMsg: from the one structured array
    that io/rosbag's deserializer gives (`points_arr`), else from per-point
    objects."""
    if hasattr(msg, "points_arr"):
        arr = msg.points_arr
        return {
            "x": np.ascontiguousarray(arr["x"]),
            "y": np.ascontiguousarray(arr["y"]),
            "z": np.ascontiguousarray(arr["z"]),
            "offset_time": arr["offset_time"].astype(np.uint64),
            "tag": np.ascontiguousarray(arr["tag"]),
        }
    return {
        "x": np.array([p.x for p in msg.points], np.float32),
        "y": np.array([p.y for p in msg.points], np.float32),
        "z": np.array([p.z for p in msg.points], np.float32),
        "offset_time": np.array([p.offset_time for p in msg.points],
                                np.uint64),
        "tag": np.array([p.tag for p in msg.points], np.uint8),
    }


def decode_image_msg(msg):
    """sensor_msgs/Image (raw) or CompressedImage -> (H, W[, C]) uint8."""
    if hasattr(msg, "format"):  # CompressedImage
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "a sensor_msgs/CompressedImage needs OpenCV (cv2) to decode, "
                "and it is not installed: install it, or record raw "
                "sensor_msgs/Image messages") from e
        return cv2.imdecode(np.frombuffer(msg.data, np.uint8),
                            cv2.IMREAD_GRAYSCALE)
    h, w = msg.height, msg.width
    ch = msg.step // w
    return np.frombuffer(msg.data, np.uint8).reshape(h, w, ch).squeeze()


def build_sequence(records, lidar_type: int, blind: float, filter_num: int):
    """Core conversion, independent of the bag reader. `records` yields
    (kind, msgtype, stamp_seconds, msg) with kind in {"imu", "lidar",
    "image"}. Returns an io.dataset.NpzSequence with timestamps rebased to
    the earliest message."""
    imu_t, gyr, acc = [], [], []
    scans = []
    images = []
    for kind, msgtype, t, msg in records:
        if kind == "imu":
            imu_t.append(t)
            gyr.append([msg.angular_velocity.x, msg.angular_velocity.y,
                        msg.angular_velocity.z])
            acc.append([msg.linear_acceleration.x, msg.linear_acceleration.y,
                        msg.linear_acceleration.z])
        elif kind == "lidar":
            fields = (livox_to_fields(msg) if "CustomMsg" in msgtype
                      else pointcloud2_to_fields(msg))
            pts, offs = lidar_mod.decode(
                lidar_type, fields, blind=blind, filter_num=filter_num)
            scans.append((t, pts, offs))
        else:
            images.append((t, decode_image_msg(msg)))

    t0 = min(
        [imu_t[0] if imu_t else np.inf]
        + [scans[0][0] if scans else np.inf]
        + [images[0][0] if images else np.inf]
    )
    return dataset.NpzSequence(
        imu_stamps=np.array(imu_t) - t0,
        imu_gyr=np.array(gyr), imu_acc=np.array(acc),
        scans=[(t - t0, p, o) for t, p, o in scans],
        images=[(t - t0, im) for t, im in images],
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fast_livo2_tpu_torch.convert_rosbag")
    ap.add_argument("bag")
    ap.add_argument("out")
    ap.add_argument("--lidar-type", type=int, default=1)
    ap.add_argument("--lid-topic", default="/livox/lidar")
    ap.add_argument("--imu-topic", default="/livox/imu")
    ap.add_argument("--img-topic", default="/left_camera/image")
    ap.add_argument("--blind", type=float, default=0.8)
    ap.add_argument("--filter-num", type=int, default=1)
    args = ap.parse_args(argv)

    kind_of = {args.imu_topic: "imu", args.lid_topic: "lidar",
               args.img_topic: "image"}

    try:
        from rosbags.highlevel import AnyReader
    except ImportError:
        AnyReader = None

    if AnyReader is not None:
        def records():
            with AnyReader([Path(args.bag)]) as reader:
                conns = [c for c in reader.connections if c.topic in kind_of]
                for conn, ts, raw in reader.messages(connections=conns):
                    msg = reader.deserialize(raw, conn.msgtype)
                    t = (msg.header.stamp.sec
                         + msg.header.stamp.nanosec * 1e-9)
                    yield kind_of[conn.topic], conn.msgtype, t, msg
    else:
        def records():
            for topic, mtype, t_recv, msg in bag_mod.read_messages(
                    args.bag, topics=list(kind_of)):
                h = getattr(msg, "header", None)
                t = (h.stamp.sec + h.stamp.nanosec * 1e-9) if h else t_recv
                yield kind_of[topic], mtype, t, msg

    seq = build_sequence(records(), args.lidar_type, args.blind,
                         args.filter_num)
    dataset.save_sequence(args.out, seq)
    print(f"wrote {args.out}: {len(seq.imu_stamps)} imu, {len(seq.scans)} "
          f"scans, {len(seq.images)} images")


if __name__ == "__main__":
    main()
