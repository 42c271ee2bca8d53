# CPU-only container (tests + decoding); for NVIDIA GPU runs install the
# matching jax[cuda12] wheel instead.
FROM python:3.12-slim
RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*
WORKDIR /app
COPY . .
RUN pip install --no-cache-dir jax numpy scipy pillow pytest && \
    make -C native
CMD ["python", "-m", "pytest", "tests/", "-q"]
