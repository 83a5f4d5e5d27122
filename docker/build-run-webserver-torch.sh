#!/usr/bin/env bash
# Build and run the PyTorch port's dashboard container over the detection
# container's data mount (as docker/build-run-webserver.sh does for the JAX
# package, including the guard that the detection mount exists first).
set -euo pipefail

DATA_DIR="${DATA_DIR:-$HOME/meteor-data}"

if [[ ! -d "$DATA_DIR/csv-out" ]]; then
    echo "ERROR: $DATA_DIR/csv-out not found — start the detection container first" >&2
    exit 1
fi

docker build -f docker/Dockerfile-Webserver-torch -t ms-torch-web .
docker rm -f ms-torch-web 2>/dev/null || true
docker run -d --name ms-torch-web \
    --restart=always \
    -p 5000:5000 \
    -v "$DATA_DIR":/data \
    ms-torch-web
echo "dashboard on http://localhost:5000/"
