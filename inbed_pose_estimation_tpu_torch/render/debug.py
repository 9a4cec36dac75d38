"""2D and 3D skeleton views for the offline tools.

The port of the JAX package's `render/debug.py` (the reference's
utils/visualize.py Debugger): 2D keypoints and the SLP 14-joint skeleton
drawn with OpenCV onto host images, shown with matplotlib, which is
imported only by the methods that show.
"""

from __future__ import annotations

import cv2
import numpy as np

# SLP 14-joint skeleton edges (ankle-knee-hip / wrist-elbow-shoulder chains).
SKELETON_14 = [
    (0, 1), (1, 2), (2, 3), (3, 4), (4, 5),
    (6, 7), (7, 8), (8, 9), (9, 10), (10, 11),
    (2, 8), (3, 9), (12, 13),
]


class Debugger:
    """Named host images to draw on, show and save."""

    def __init__(self):
        self.imgs = {}

    def add_img(self, img, img_id="default"):
        self.imgs[img_id] = np.asarray(img).copy()

    def add_point_2d(self, points, color=(255, 0, 0), img_id="default"):
        img = self.imgs[img_id]
        for p in np.asarray(points).astype(int):
            cv2.circle(img, (int(p[0]), int(p[1])), 3, color, -1)

    def add_skeleton_2d(self, joints, img_id="default", color=(0, 255, 0)):
        img = self.imgs[img_id]
        joints = np.asarray(joints)
        for a, b in SKELETON_14:
            if a < len(joints) and b < len(joints):
                cv2.line(img, tuple(joints[a, :2].astype(int)), tuple(joints[b, :2].astype(int)), color, 1)

    def show_img(self, img_id="default", pause=False):
        import matplotlib.pyplot as plt

        plt.figure()
        plt.imshow(self.imgs[img_id].astype(np.uint8))
        plt.show(block=pause)

    def show_3d(self, points, labels=None):
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        pts = np.asarray(points)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2])
        plt.show()

    def save_img(self, path, img_id="default"):
        """Write the image, RGB order turned into OpenCV's BGR."""
        img = self.imgs[img_id]
        cv2.imwrite(path, img[:, :, ::-1] if img.ndim == 3 else img)
