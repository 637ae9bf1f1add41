"""Host-side preprocessing: video extraction, lens calibration,
undistortion, and COLMAP pose estimation (counterpart of the JAX package's
top-level preprocess.py; the port's own copy, on
nonrigid_nerf_torch.preprocessing).

CLI mirrors the reference (reference: preprocess.py:339-415):

  python3 -m nonrigid_nerf_torch.cli.preprocess --input <video file | folder with images/>
      [--output DIR] [--fps N] [--ffmpeg_path P]
      [--calibrate_lens_distortion --checkerboard_width W
       --checkerboard_height H [--visualize_detections]
       [--undistort_calibration_images]]
      [--undistort_with_calibration_file lens_distortion.json]
      [--colmap_matching sequential_matcher|exhaustive_matcher]

All of this stays on the host CPU (ffmpeg / OpenCV / COLMAP are external
native tools, exactly as in the reference, SURVEY.md L0/L1).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
from multiprocessing import Pool

import numpy as np

from nonrigid_nerf_torch.preprocessing import gen_poses


def create_folder(folder):
    os.makedirs(folder, exist_ok=True)


def _ffmpeg(ffmpeg_path, arglist, what):
    try:
        subprocess.run([ffmpeg_path] + arglist, check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"ffmpeg binary {ffmpeg_path!r} not found ({what}); install "
            "ffmpeg or pass --ffmpeg_path")


def video_preprocessing(args):
    """Extract frames at --fps, honour the images_failed/ deletion list, and
    assemble a full-resolution preview video
    (reference: preprocess.py:131-189)."""
    images_folder = os.path.join(args.output, "images")
    create_folder(images_folder)

    _ffmpeg(args.ffmpeg_path,
            ["-i", args.input, "-f", "image2", "-qscale:v", "2",
             "-vf", f"fps={args.fps}",
             os.path.join(images_folder, "image%05d.png")],
            "frame extraction")

    failed_folder = os.path.join(args.output, "images_failed")
    if os.path.exists(failed_folder):
        failed = os.listdir(failed_folder)
        print("detected failed frames, deleting:", failed, flush=True)
        for name in failed:
            path = os.path.join(images_folder, name)
            if os.path.exists(path):
                os.remove(path)

    print("creating full-resolution RGB preview video...", flush=True)
    _ffmpeg(args.ffmpeg_path,
            ["-framerate", str(args.fps), "-i",
             os.path.join(images_folder, "image%05d.png"), "-y",
             os.path.join(args.output, "rgb_scene_fullres.mp4")],
            "preview video")


def lens_distortion_calibration(args):
    """OpenCV checkerboard calibration -> lens_distortion.json
    (reference: preprocess.py:14-128)."""
    import cv2

    input_folder = os.path.join(args.input, "images")
    images = [f for f in sorted(os.listdir(input_folder))
              if f[-4:] in (".png", ".jpg")]

    if args.visualize_detections:
        detected_folder = os.path.join(args.output, "detected")
        create_folder(detected_folder)

    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
    board = (args.checkerboard_height, args.checkerboard_width)
    objp = np.zeros((board[0] * board[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0:board[0], 0:board[1]].T.reshape(-1, 2)

    objpoints, imgpoints = [], []
    gray = None
    height = width = None
    for i, filename in enumerate(images):
        print(f"{i} / {len(images)} {filename}", flush=True)
        img = cv2.imread(os.path.join(input_folder, filename))
        height, width = img.shape[:2]
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        found, corners = cv2.findChessboardCorners(gray, board, None)
        if found:
            objpoints.append(objp)
            corners = cv2.cornerSubPix(gray, corners, (5, 5), (-1, -1),
                                       criteria)
            imgpoints.append(corners)
            if args.visualize_detections:
                cv2.drawChessboardCorners(img, board, corners, found)
                cv2.imwrite(os.path.join(detected_folder, filename), img)

    if not objpoints:
        raise RuntimeError("no checkerboards detected — check "
                           "--checkerboard_width/height (inner corners)")

    print("computing calibration...", flush=True)
    rmse, mtx, dist, _, _ = cv2.calibrateCamera(
        objpoints, imgpoints, gray.shape[::-1], None, None)
    print(f"RMSE (in pixel units): {rmse}", flush=True)

    calibration = {
        "newcameramtx": mtx.tolist(),
        "mtx": mtx.tolist(),
        "dist": dist.tolist(),
        "roi": (0, 0, width, height),
    }
    with open(os.path.join(args.output, "lens_distortion.json"), "w") as f:
        json.dump(calibration, f, indent=4)

    if args.undistort_calibration_images:
        undist_folder = os.path.join(args.output, "undistorted")
        create_folder(undist_folder)
        for i, filename in enumerate(images):
            _undistort_one((i, filename, input_folder, undist_folder,
                            calibration, undist_folder))


def _undistort_one(task):
    """Worker: undistort one image; index 0 also writes the valid-pixel
    mask (reference: preprocess.py:192-233)."""
    import cv2
    i, filename, distorted_folder, undistorted_folder, params, \
        mask_folder = task
    img = cv2.imread(os.path.join(distorted_folder, filename))
    mtx = np.asarray(params["mtx"])
    dist = np.asarray(params["dist"])
    newcameramtx = np.asarray(params["newcameramtx"])
    x, y, w, h = params["roi"]
    out = cv2.undistort(img, mtx, dist, None, newcameramtx)[y:y + h, x:x + w]
    cv2.imwrite(os.path.join(undistorted_folder, filename), out)
    if i == 0:
        mask = (255.0 * (np.sum(out == 0, axis=-1) != 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(mask_folder, "mask.png"), mask)


def undistort(args, workers: int = 5):
    """Undistort an image sequence with a saved calibration, in a worker
    pool (reference: preprocess.py:236-302)."""
    calib_file = args.undistort_with_calibration_file
    if os.path.isdir(calib_file):
        calib_file = os.path.join(calib_file, "lens_distortion.json")
    with open(calib_file) as f:
        params = json.load(f)

    if os.path.normpath(args.input) == os.path.normpath(args.output):
        distorted_folder = os.path.join(args.output, "distorted_images")
        undistorted_folder = os.path.join(args.input, "images")
        shutil.move(undistorted_folder, distorted_folder)
    else:
        distorted_folder = os.path.join(args.input, "images")
        undistorted_folder = os.path.join(args.output, "images")
    create_folder(undistorted_folder)
    mask_folder = undistorted_folder.rstrip("/") + "_mask"
    create_folder(mask_folder)

    images = [f for f in sorted(os.listdir(distorted_folder))
              if f[-4:] in (".png", ".jpg")]
    tasks = [(i, f, distorted_folder, undistorted_folder, params,
              mask_folder) for i, f in enumerate(images)]
    if workers <= 1:
        # inline path: also safe inside processes that already initialized
        # accelerator runtimes (fork-unsafe)
        for task in tasks:
            _undistort_one(task)
    else:
        with Pool(workers) as pool:
            pool.map(_undistort_one, tasks)

    with open(os.path.join(args.output, "undistorted_calibration.txt"),
              "w") as f:
        cam = params["newcameramtx"]
        f.write(f"color fx {cam[0][0]}\n")
        f.write(f"color fy {cam[1][1]}\n")
        f.write(f"color cx {cam[0][2]}\n")
        f.write(f"color cy {cam[1][2]}\n")


def preprocess(args):
    if not os.path.exists(args.input):
        raise FileNotFoundError(
            f"--input {args.input!r} does not exist (expected a video file "
            "or a folder containing images/)")
    if args.output is None:
        if os.path.isfile(args.input):
            folder, fname = os.path.split(args.input)
            args.output = os.path.join(folder, os.path.splitext(fname)[0])
        else:
            args.output = args.input
    create_folder(args.output)

    if os.path.isfile(args.input):
        video_preprocessing(args)
        args.input = args.output

    if args.calibrate_lens_distortion:
        lens_distortion_calibration(args)
        return

    if args.undistort_with_calibration_file is not None:
        undistort(args)

    gen_poses(args.input, args.colmap_matching, args.colmap_path)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=str, required=True,
                        help="video file, or folder containing images/")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--colmap_matching", type=str,
                        default="sequential_matcher",
                        choices=["sequential_matcher", "exhaustive_matcher"])
    parser.add_argument("--colmap_path", type=str, default="colmap")
    parser.add_argument("--ffmpeg_path", type=str, default="ffmpeg")
    parser.add_argument("--fps", type=int, default=5)
    parser.add_argument("--undistort_with_calibration_file", type=str,
                        default=None)
    parser.add_argument("--calibrate_lens_distortion", action="store_true")
    parser.add_argument("--checkerboard_width", type=int, default=5)
    parser.add_argument("--checkerboard_height", type=int, default=5)
    parser.add_argument("--visualize_detections", action="store_true")
    parser.add_argument("--undistort_calibration_images", action="store_true")
    return parser


def main(argv=None) -> int:
    preprocess(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
