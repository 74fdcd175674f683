"""The live mix on a fake clock: latency runs from the due time of a
frame's last required input (its scan's end, the IMU sample past it, the
image) to its pose on the host, so a push that ran late counts in it."""

import numpy as np

from livo_bench.lib import drive, generator


class FakeClock:
    def __init__(self):
        self.t = 100.0
        self.stall_at = None  # (sensor-free) one sleep that overshoots

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += s
        if self.stall_at is not None and self.t >= self.stall_at:
            self.t += 0.05
            self.stall_at = None


class FakePipe:
    """Runs an image event once its IMU and LiDAR cover it; a frame costs
    20 ms of clock time."""

    def __init__(self, clock):
        self.clock = clock
        self.imu_last = -1.0
        self.horizon = -1.0
        self.images = []
        self.trajectory = []
        self.last_update_time = 0.0

    def push_imu(self, t, g, a):
        self.imu_last = float(t[-1])

    def push_scan(self, tb, p, o):
        self.horizon = max(self.horizon, tb + float(o.max()))

    def push_image(self, t, img):
        self.images.append(t)

    def poll(self, max_frames=None):
        if self.images and self.imu_last > self.images[0] and self.horizon >= self.images[0]:
            t = self.images.pop(0)
            self.clock.t += 0.02
            self.trajectory.append((t, None))
            self.last_update_time = t
            return 1
        return 0


def recording(seconds=2.0):
    imu_t = np.arange(0.0, seconds, 0.005)
    scans = [(tb, np.zeros((4, 3), np.float32),
              np.array([0.0, 0.03, 0.06, 0.0999], np.float32))
             for tb in np.arange(0.05, seconds - 0.1, 0.1)]
    images = [(t, np.zeros((2, 2), np.uint8)) for t in np.arange(0.1, seconds, 0.1)]
    z = np.zeros((len(imu_t), 3))
    return generator.Recording(imu_t, z, z, scans, images, np.zeros(0),
                               np.zeros((0, 3, 3)), np.zeros((0, 3)))


def test_latency_from_due():
    clock = FakeClock()
    pipe = FakePipe(clock)
    feed = drive.Feed(recording(), 0.1, 0.0)
    drv = drive.Runner(pipe, feed, clock, drive.Spans(),
                       read_pose=lambda row: setattr(clock, "t", clock.t + 0.001))
    drv.warm(0.5)
    clock.stall_at = clock.t + 0.73  # one push ~0.73 s into the window runs 50 ms late
    frames = drv.live(0.5, 1.0)
    assert len(frames) == 10
    lat = np.array([f.out - f.due for f in frames])
    # an image at t is due at its scan's end, t + 0.05 (the IMU sample
    # past t arrives 5 ms after t, the image at t)
    for f in frames:
        assert abs(feed.ready_due[f.t_ev] - (f.t_ev + 0.05)) < 1e-9
    # a frame costs 20 ms and its pose read 1 ms; the stalled push delays
    # one frame, and the delay counts in its latency
    assert np.sum(np.abs(lat - 0.021) < 1e-9) == 9
    slow = lat[np.abs(lat - 0.021) >= 1e-9]
    assert len(slow) == 1 and 0.021 < slow[0] <= 0.021 + 0.05 + 1e-9
    assert max(drv.late) >= 0.05 - 1e-9
