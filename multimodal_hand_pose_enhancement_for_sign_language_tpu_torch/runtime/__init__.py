"""Host-side native helpers (the OpenPose frame scanner); numpy and ctypes only."""
