#!/usr/bin/env bash
# Build and run the PyTorch port's detection container on the GPU with
# restart-on-crash supervision (as docker/build-run-detection.sh does for
# the JAX package).
set -euo pipefail

DATA_DIR="${DATA_DIR:-$HOME/meteor-data}"
STREAM_URL="${STREAM_URL:?set STREAM_URL to the audio stream to monitor}"

mkdir -p "$DATA_DIR/csv-out" "$DATA_DIR/spec-out"

docker build -f docker/Dockerfile-Detection-torch -t ms-torch-detect .
docker rm -f ms-torch-detect 2>/dev/null || true
docker run -d --name ms-torch-detect \
    --restart=always \
    --gpus all \
    -e STREAM_URL="$STREAM_URL" \
    -v "$DATA_DIR":/data \
    ms-torch-detect
echo "detection container running; ledger at $DATA_DIR/csv-out"
