"""Host-side helpers of the port: image files, visualizations, videos and
the scene-volume probe."""
