# GuideMaker-TPU container (CPU backend; for a GPU use a CUDA base image
# and install jax[cuda12] in place of jax).
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/guidemaker-tpu
COPY pyproject.toml README.md ./
COPY guidemaker_tpu ./guidemaker_tpu
RUN pip install --no-cache-dir jax numpy pandas pyarrow pyyaml pytest \
    && pip install --no-cache-dir -e . \
    && make -C guidemaker_tpu/native

ENTRYPOINT ["guidemaker-tpu"]
CMD ["--help"]
